"""The VSR replica: consensus, commit pipeline, view change, WAL repair.

Re-designs upstream src/vsr/replica.zig (9.4k LoC of Zig) as a
deterministic event-driven Python core with injected IO: `bus` delivers and
sends messages, `time` supplies ticks, `storage` backs the journal and
superblock, and the CUDA-accelerated StateMachine executes committed ops.
The protocol implemented:

  normal:      on_request (:1309) → primary_pipeline_prepare (:5130) →
               on_prepare (:1365) → journal write → prepare_ok (:1470) →
               quorum → commit_op (:3679) → reply; backups commit via the
               piggybacked commit number and the commit heartbeat (:1592).
  view change: SVC/DVC/start_view (:1703-1902) with longest-log selection.
  repair:      request_prepare / on_request_prepare (:2049) for WAL gaps.
  checkpoint:  state-machine snapshot + superblock advance every
               checkpoint_interval ops (simplified grid: whole-state
               snapshot).

Determinism: every state transition is a pure function of (durable state,
delivered messages, tick counter) — the cluster simulator replays a seed to
an identical execution, byte-for-byte (SURVEY.md §4 keystone).
"""

from __future__ import annotations

import importlib
import logging
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.constants import Config
from tigerbeetle_tpu_torch.io.grid import GridReadFault
from tigerbeetle_tpu_torch.io.storage import Zone
from tigerbeetle_tpu_torch.models.state_machine import StateMachine
from tigerbeetle_tpu_torch.vsr import header as hdr
from tigerbeetle_tpu_torch.vsr import snapshot
from tigerbeetle_tpu_torch.vsr.clock import Clock, DeterministicTime
from tigerbeetle_tpu_torch.vsr.clocksync import ClockSync
from tigerbeetle_tpu_torch.vsr.peerstats import PeerStats
from tigerbeetle_tpu_torch.vsr.header import (
    Command, Header, Message, Operation, RECONFIGURE_DTYPE,
)
from tigerbeetle_tpu_torch.vsr.journal import Journal
from tigerbeetle_tpu_torch.vsr.superblock import NO_TRAILER, SuperBlock, VSRState

STATUS_NORMAL = "normal"
STATUS_VIEW_CHANGE = "view_change"
STATUS_RECOVERING = "recovering"

# vsr.recovery_state gauge values (docs/CHAOS.md recovery lifecycle):
# the dominant phase between a crash and the first post-restart commit at
# the cluster tip. GRID_REPAIR also covers normal-operation repair gates
# (commits stall identically either way).
RECOVERY_STATE_NORMAL = 0
RECOVERY_STATE_DISCOVER = 1  # restarted, learning the cluster's view
RECOVERY_STATE_WAL_REPLAY = 2  # open(): re-executing committed prepares
RECOVERY_STATE_VIEW_CHANGE = 3
RECOVERY_STATE_SYNC = 4  # chunked checkpoint-trailer transfer
RECOVERY_STATE_BLOCK_SYNC = 5  # fetching referenced grid blocks
RECOVERY_STATE_GRID_REPAIR = 6  # commit gate: block repair / parked finish
RECOVERY_STATE_CATCH_UP = 7  # normal status, commit_min < commit_max

# Scoped logger (reference std.log scoped loggers; silent unless the
# embedder configures logging — the simulator leaves it off for speed).
log = logging.getLogger("tigerbeetle_tpu_torch.replica")

# Tick counts (the reference's timeouts, replica.zig:2535-2861, scaled to
# abstract ticks; the production loop maps ticks to ~10ms).
PING_TIMEOUT = 50
PREPARE_TIMEOUT = 30
COMMIT_HEARTBEAT_TIMEOUT = 40
NORMAL_HEARTBEAT_TIMEOUT = 200
VIEW_CHANGE_TIMEOUT = 300
REPAIR_TIMEOUT = 20
# Latency-based admission (config.admission_p99_ms) refresh cadence: the
# windowed perceived-p99 read takes the tracer registry lock, so it runs
# every N ticks (~100 ms on the production 10 ms tick), never per request.
ADMISSION_CHECK_TICKS = 10


def _parse_headers(body: bytes) -> List[Header]:
    """One np.frombuffer over the whole body instead of a per-header
    slice+copy loop: each Header wraps a record view of the single
    (mutable) backing buffer."""
    n = len(body) // hdr.HEADER_SIZE
    if n == 0:
        return []
    recs = np.frombuffer(
        bytearray(body[: n * hdr.HEADER_SIZE]), dtype=hdr.HEADER_DTYPE
    )
    return [Header(recs[i]) for i in range(n)]


def _event_dtype(operation: int, body_len: int = -1) -> np.dtype:
    if operation == Operation.CREATE_ACCOUNTS:
        return types.ACCOUNT_DTYPE
    if operation == Operation.CREATE_TRANSFERS:
        return types.TRANSFER_DTYPE
    if operation in (Operation.LOOKUP_ACCOUNTS, Operation.LOOKUP_TRANSFERS):
        return types.ID_DTYPE
    if operation in (Operation.QUERY_ACCOUNTS, Operation.QUERY_TRANSFERS):
        # Size-discriminated filter version: the v2 shape (account-id
        # predicates of the scan engine) is a strict byte-superset of
        # v1, so the body length IS the version tag and v1 clients need
        # no change (_request_valid admits exactly the two sizes).
        if body_len == types.QUERY_FILTER_V2_DTYPE.itemsize:
            return types.QUERY_FILTER_V2_DTYPE
        return types.QUERY_FILTER_DTYPE
    return types.ACCOUNT_FILTER_DTYPE


# The modules the serving path imports inside functions: the store stage's
# query index and scans, the flush and compaction folds, the exact route
# and the stages themselves. A module's first import compiles and runs it
# under the interpreter lock; in a replica's first store jobs on the card
# that held its event loop for 10-20 ms and delayed its prepare_oks
# (PERF.md section 7), so Replica._warm imports them at open.
SERVING_MODULES = (
    "tigerbeetle_tpu_torch.lsm.scan",
    "tigerbeetle_tpu_torch.lsm.groove",
    "tigerbeetle_tpu_torch.ops.qindex",
    "tigerbeetle_tpu_torch.ops.merge",
    "tigerbeetle_tpu_torch.ops.scanops",
    "tigerbeetle_tpu_torch.ops.commit_exact",
    "tigerbeetle_tpu_torch.vsr.pipeline",
)


class ClientSession:
    __slots__ = ("session", "request", "reply", "last_op")

    def __init__(self, session: int) -> None:
        self.session = session
        self.request = 0
        self.reply: Optional[Message] = None
        # Op number of the session's last committed request — replicated
        # state (applied identically at commit on every replica), so the
        # LRU eviction order derived from it is deterministic and
        # survives checkpoint round-trips (vsr/snapshot.py rebuilds the
        # client-table dict sorted by last_op).
        self.last_op = session


class Pipeline:
    """Primary-side prepare pipeline (reference replica.zig:100-115)."""

    __slots__ = ("message", "ok_from")

    def __init__(self, message: Message) -> None:
        self.message = message
        self.ok_from: set[int] = set()


class Replica:
    def __init__(
        self,
        *,
        cluster: int,
        replica_index: int,
        replica_count: int,
        storage,
        zone: Zone,
        config: Config,
        bus,
        device=None,
        device_query_index: Optional[bool] = None,
        on_event: Optional[Callable[[str, "Replica"], None]] = None,
        time=None,
        aof=None,
        standby_count: int = 0,
    ) -> None:
        self.cluster = cluster
        self.replica = replica_index
        self.replica_count = replica_count
        # Standbys (reference constants.zig:33, ≤6): replica indexes
        # [replica_count, replica_count+standby_count) replicate passively —
        # they journal + commit every prepare but never ack, vote, or count
        # toward any quorum. A committed RECONFIGURE op promotes one into a
        # vacated active slot (reference commit_reconfiguration,
        # replica.zig:3842 — a stub there; a working promotion path here).
        self.standby_count = standby_count
        # Set when a committed RECONFIGURE reassigned this replica's slot
        # while it was down: the node must never participate again.
        self.retired = False
        # (standby, target) pairs whose RECONFIGURE this replica has
        # committed — primary-side dedupe of duplicate operator requests.
        self.reconfigures_applied: set = set()
        # Configuration epoch = count of committed RECONFIGUREs (reference
        # epoch semantics), carried on quorum-vote messages (PREPARE_OK /
        # SVC / DVC). The fence is PER SLOT: slot_epoch[i] is the epoch at
        # which slot i was last reassigned, and a vote from slot i below
        # that epoch is dropped — it can only come from the STALE occupant
        # (the promoted occupant committed the reassigning RECONFIGURE, so
        # its votes carry at least that epoch). A merely-lagging member of
        # a never-reassigned slot keeps full quorum weight, so the fence
        # can never starve a legitimate view change (a global `epoch <
        # ours` drop would: a member that missed the RECONFIGURE commit
        # could neither vote nor, primary-less, ever catch up).
        # Residual window, as in the reference's epoch design: a receiver
        # that has NOT yet committed the RECONFIGURE has no slot_epoch
        # entry and still accepts the stale occupant's votes until its own
        # commit catches up.
        # Both values are rebuilt deterministically by WAL replay and are
        # persisted ONLY at checkpoint boundaries / in the snapshot blob
        # (mid-commit persistence would double-count on replay).
        self.config_epoch = 0
        self.slot_epoch: Dict[int, int] = {}
        # Eviction decisions are deferred while ops at or below this floor
        # (the suffix inherited at election) are uncommitted — set when
        # becoming primary of a new view / opening.
        self._eviction_floor = 0
        self.config = config
        self.storage = storage
        self.zone = zone
        self.bus = bus
        # The state machine's placement, passed through unchanged:
        # device=None is the CUDA card (and raises where there is none),
        # device="cpu" runs every kernel's plain version.
        self.device = device
        self.device_query_index = device_query_index
        # Grid blocks of the current checkpoint trailer (index block first);
        # stage-released when the next checkpoint supersedes them.
        self._trailer_blocks: List[int] = []
        # Optional append-only file of committed prepares (vsr/aof.py;
        # reference hook at replica.zig:3745).
        self.aof = aof
        self.on_event = on_event or (lambda kind, r: None)

        self.superblock = SuperBlock(storage, zone)
        self.journal = Journal(
            storage, zone, config.journal_slot_count, config.message_size_max
        )
        # Durable LSM tier over the data file's grid zone (deferred frees:
        # blocks of the last durable checkpoint are never reused before the
        # next checkpoint commits). Zones without a grid (journal-only unit
        # fixtures) fall back to the state machine's in-memory grid.
        if zone.grid_size:
            from tigerbeetle_tpu_torch.io.grid import Grid

            self.grid = Grid(
                storage, zone.grid_offset, zone.grid_block_count,
                zone.grid_block_size, defer_releases=True,
                cache_blocks=config.grid_cache_blocks,
            )
        else:
            self.grid = None
        self.state_machine = StateMachine(
            config, device=device, grid=self.grid,
            device_query_index=device_query_index,
        )

        self.status = STATUS_RECOVERING
        self.view = 0
        self.log_view = 0
        self.op = 0  # highest op in journal
        self.commit_min = 0  # highest committed AND executed
        self.commit_max = 0  # highest committable known
        self.pipeline: List[Pipeline] = []
        # FIFO backlog of admitted requests waiting for a pipeline slot.
        # A deque: at 10k sessions the old list.pop(0) drain was O(n) per
        # prepared request — quadratic exactly when the queue is deepest.
        self.request_queue: Deque[Message] = deque()
        # client → request number of that client's queued entry. One
        # queued request per session (fair drain: a session that floods
        # past the one-in-flight contract is shed with BUSY, it cannot
        # occupy more than one backlog slot) and O(1) resend suppression
        # (the old per-arrival linear scan of request_queue was O(n) at
        # exactly the depth admission control now allows).
        self._queued_req: Dict[int, int] = {}
        # Latency-derived admission state (config.admission_p99_ms):
        # updated at tick granularity from the tracer's running perceived
        # histogram, consulted per arrival — never computed per request.
        self._latency_shed = False
        self._adm_p99_state: dict = {}
        # Insertion order of `clients` IS the LRU order: every committed
        # request for a session pops + reinserts it (O(1) move-to-end),
        # so eviction takes the first key — no O(n) min-scan. Applied at
        # commit in op order on every replica → deterministic.
        self.clients: Dict[int, ClientSession] = {}

        self.start_view_change_from: Dict[int, set[int]] = {}  # view -> replicas
        self.do_view_change_from: Dict[int, Dict[int, Message]] = {}
        self._dvc_sent_for_view = -1
        # op → winning Header: the authoritative prepare content this replica
        # must hold at that op, installed from winning DVC / SV / HEADERS
        # bodies. A local prepare whose body differs is stale and must be
        # repaired before it may be re-proposed, committed, or served to
        # peers. Replaced wholesale at each view change; entries are popped
        # as their ops are repaired or committed. Quorum-backed (DVC/SV)
        # targets are additionally installed into the journal header ring so
        # they survive restart (reference replace_header); HEADERS-derived
        # targets are weaker — in-memory only, aged out on repair timeout.
        self.repair_target: Dict[int, Header] = {}
        self.repair_target_weak: Dict[int, int] = {}  # op → install tick

        # Chunked state-sync progress (receiver side) and the serve-side
        # (checkpoint_op, blob, checksum) cache.
        self._sync: Optional[dict] = None
        self._sync_serve_cache: Optional[tuple] = None
        # Block-level sync progress: {missing: {index: cks}, requested,
        # peer, last_tick, stalls, fetched}; commits are gated while set.
        self._block_sync: Optional[dict] = None
        # Normal-operation grid repair (reference grid_blocks_missing.zig:
        # block repair is an always-on protocol, not a sync mode): a
        # corrupt block read during commit/query raises GridReadFault; the
        # op is requeued, the block fetched from a peer, rewritten in
        # place, and the op retried. Commits gate while active so the
        # deterministic allocation order is preserved (a replica that
        # skipped a compaction beat would diverge byte-wise).
        self._grid_repair: Optional[dict] = None
        # The _finish_commit (store/compaction) of an already-committed op
        # faulted: it must complete after repair BEFORE any further op.
        self._finish_pending = False
        # That op's lifecycle record, so the resumed finish still gets
        # its store stamps (the faulted tail op is exactly the record
        # the flight dump exists to explain).
        self._finish_lc = None
        # A checkpoint's trailer write faulted mid-drain (corrupt
        # compaction input found while draining): retried after repair.
        self._checkpoint_pending = False

        # Injected time + cluster clock (reference clock.zig via ping/pong
        # offset samples; DeterministicTime keeps simulations reproducible).
        self.time = time if time is not None else DeterministicTime()
        self.clock = Clock(self.time, replica_count, replica_index)
        # Cluster-plane telemetry (docs/OBSERVABILITY.md "cluster
        # plane"): per-peer replication stamps + quorum attribution on
        # the primary, and the telemetry half of clock estimation over
        # the same ping/pong samples the state-machine clock already
        # learns from. Pure observability — neither is read by any
        # commit/prepare path, and the telemetry-on-vs-off determinism
        # guard proves replicated bytes are identical either way.
        self.peer_stats = PeerStats(replica_index, replica_count)  # tidy: owner=loop
        self.clocksync = ClockSync(replica_index, replica_count)  # tidy: owner=loop

        # Timestamp high-water of COMMITTED prepares only: checkpoints must
        # capture replicated state, and the primary's sm.prepare_timestamp
        # runs ahead for in-flight (uncommitted) prepares — snapshotting it
        # would make checkpoint bytes differ per replica (caught by the
        # storage checker).
        self.committed_timestamp_max = 0

        self.tick_count = 0
        self.last_heartbeat_tick = 0
        self.last_commit_sent_tick = 0
        self.last_repair_tick = 0
        self.recovering_since = 0
        # replica → (view, is_normal) pongs collected while recovering.
        self._recovery_pongs: Dict[int, tuple] = {}

        # Recovery lifecycle observability (docs/CHAOS.md): open() fills
        # wal_replay_{ops,s} / replay_ops_per_s, the caught-up detector in
        # _recovery_tick adds time_to_rejoin_s. Wall-clock here is
        # observability-only and never reaches replicated state; the
        # deterministic phase tracking (stall detection, gauge) runs on
        # tick counts.
        self.recovery_stats: Dict[str, float] = {}
        self._recovery_active = False
        self._recovery_t0 = 0.0
        self._recovery_progress_tick = 0
        self._recovery_progress_commit = 0
        self._recovery_progress_fetch = 0
        self._recovery_stall_tripped = False
        self._recovery_gauge_last = -1

        # View-change lifecycle observability (docs/CHAOS.md failover
        # timeline, same taxonomy as recovery_stats): one episode spans
        # leaving normal status to the new view serving. Phases — svc_wait
        # (enter view_change → SVC quorum/DVC sent), dvc_collect (DVC sent
        # → DVC quorum, new primary only), sv_replay (become primary →
        # inherited suffix committed + re-proposed), sv_adopt (backup:
        # enter → START_VIEW installed). Wall-clock, observability only —
        # never reaches replicated state; mirrored as vsr.view_change.*
        # gauges so a failover flight dump decomposes the blackout.
        self.view_change_stats: Dict[str, float] = {}
        self._vc_t0: Optional[float] = None
        self._vc_dvc_t: Optional[float] = None

        # commit-number → checksum chain, used by the state checker. Ops at
        # or below checksum_floor were recovered from a checkpoint snapshot
        # and have no individually recorded checksum.
        self.commit_checksums: Dict[int, int] = {}
        self.checksum_floor = 0

        # Optional WAL writer thread (vsr/journal.WalWriter): when set,
        # prepare bodies are written O_DIRECT|O_DSYNC off the event loop
        # and acks (self prepare_ok / backup PREPARE_OK) are deferred to
        # the write's completion — durability-before-ack preserved while
        # the DMA overlaps execution. None = synchronous write+fsync per
        # prepare (tests, simulator: deterministic single-thread
        # semantics).
        self.wal_writer = None
        # Optional overlapped commit stage (vsr/pipeline.CommitExecutor,
        # wired via attach_executor): committed prepares execute on a
        # dedicated thread, strictly in op order, while the event loop
        # keeps pumping sockets/prepare_oks/heartbeats. None = serial
        # inline commits (tests, deterministic simulator).
        self.executor = None
        # Optional deferred-store stage (vsr/pipeline.StoreExecutor, wired
        # via attach_store_executor): after an op's reply is posted, its
        # groove/index writes and compaction beat run as a coalesced job
        # on a dedicated thread, strictly in op order. None = store+beat
        # inline in _finish_commit (tests, deterministic simulator).
        self.store_executor = None
        # The faulted store job parked on the stage, held for resubmission
        # once its grid repair completes (the job resumes, never re-runs).
        self._store_resume: Optional[dict] = None
        # Jobs handed to the stage but not yet completion-applied, in op
        # order. commit_min advances only as completions are applied.
        self._staged: List[dict] = []
        # Executor-thread-owned: the cross-batch commit window — jobs
        # whose device kernels are dispatched but not yet synced, in op
        # order (docs/COMMIT_PIPELINE.md cross-batch pipelining). Up to
        # commit_depth batches ride here so batch N+1's dispatch overlaps
        # batch N's finish → reply → store hand-off; finishes retire
        # strictly from the left (op order), so hash_log chains, grid
        # allocation order, and checkpoint bytes are depth-independent.
        self._stage_window: Deque[dict] = deque()
        # Max in-flight dispatched batches (1 = single-phase execution
        # inside the stage; the pre-depth double-buffer ≡ 2). Set by
        # attach_executor; bounded by the state machine's scratch ring.
        self.commit_depth = 1
        # High-water of the window depth (executor-thread-owned, read
        # after quiesce by tests/benchmarks that assert overlap happened).
        self.stage_inflight_max = 0
        self._stage_quiescing = False
        self._reply_builder: Optional[hdr.ReplyBuilder] = None

    # ------------------------------------------------------------------

    @property
    def quorum_replication(self) -> int:
        # reference vsr.zig:910 flexible quorums
        return {1: 1, 2: 2, 3: 2, 4: 2, 5: 3, 6: 3}[self.replica_count]

    @property
    def quorum_view_change(self) -> int:
        return {1: 1, 2: 2, 3: 2, 4: 3, 5: 3, 6: 4}[self.replica_count]

    def primary_index(self, view: int) -> int:
        return view % self.replica_count

    @property
    def is_standby(self) -> bool:
        return self.replica >= self.replica_count

    @property
    def is_primary(self) -> bool:
        return self.status == STATUS_NORMAL and self.primary_index(self.view) == self.replica

    @property
    def is_backup(self) -> bool:
        return self.status == STATUS_NORMAL and not self.is_primary

    @property
    def commit_staged(self) -> int:
        """Highest op handed to the commit stage (== commit_min when the
        stage is empty or the replica runs serial commits)."""
        return self._staged[-1]["op"] if self._staged else self.commit_min

    # ------------------------------------------------------------------
    # lifecycle

    @staticmethod
    def format(storage, zone: Zone, cluster: int, replica_index: int, replica_count: int) -> None:
        """Write a fresh data file (reference vsr/replica_format.zig)."""
        sb = SuperBlock(storage, zone)
        sb.format(
            VSRState(cluster=cluster, replica=replica_index, replica_count=replica_count)
        )
        # Zero WAL header ring so recovery sees clean slots.
        zeros = b"\x00" * 4096
        off = zone.wal_headers_offset
        end = off + zone.wal_headers_size
        while off < end:
            storage.write(off, zeros[: min(4096, end - off)])
            off += 4096
        storage.sync()

    def _warm(self) -> None:
        """First-call work, done at open before the replica serves: import
        SERVING_MODULES and, on the card, load every kernel library
        (ops/kernels.py builds one that is missing). It reads and writes
        no tree, journal or grid, so no replicated byte can change."""
        for name in SERVING_MODULES:
            importlib.import_module(name)
        if self.state_machine.device.type == "cuda":
            from tigerbeetle_tpu_torch.ops import kernels

            for name in kernels.SIGNATURES:
                kernels.entry(name)

    def open(self) -> None:
        import time as _time

        self._warm()
        t_open = _time.perf_counter()  # tidy: allow=wall-clock — recovery observability only, never reaches replicated state
        tracer.count("recovery.boot")
        tracer.gauge("vsr.recovery_state", RECOVERY_STATE_WAL_REPLAY)
        st = self.superblock.open()
        assert st.cluster == self.cluster and st.replica == self.replica
        self.view = st.view
        self.log_view = st.log_view
        self.commit_min = st.op_checkpoint
        self.commit_max = max(st.commit_max, st.op_checkpoint)
        self.checksum_floor = st.op_checkpoint
        self.config_epoch = st.config_epoch
        self.slot_epoch = {}  # rebuilt by snapshot install + WAL replay

        resume_block_sync: Optional[Dict[int, int]] = None
        if st.op_checkpoint > 0:
            # Load the checkpoint trailer the superblock references — by
            # construction EXACTLY the durable checkpoint's state (a newer
            # trailer written by a crash between trailer write and
            # superblock advance occupies unreferenced blocks and is
            # simply never read: stale-future safety by pointer identity).
            assert st.trailer_block != NO_TRAILER, (
                "superblock references a checkpoint but carries no trailer"
            )
            blob = self._trailer_read(st.trailer_block)
            if st.sync_pending:
                # Crashed mid block-sync: the trailer's RAM state is valid
                # but referenced content blocks may still be missing —
                # resume fetching before any execution (the Bloom rebuild
                # waits too: it scans log blocks).
                tracer.count("mark.state_sync_install")
                resume_block_sync = snapshot.block_checksums(blob)
                snapshot.install(
                    self, blob, rebuild_bloom=False,
                    block_cks_map=resume_block_sync,
                )
            else:
                try:
                    self._load_snapshot(blob)
                except GridReadFault:
                    # A checkpoint-referenced block is corrupt on disk
                    # (latent sector error found at boot — the bloom
                    # rebuild scans every log block): install the RAM
                    # state without the scan and fetch ONLY the bad
                    # blocks via block-level sync. (Blocks written after
                    # the checkpoint are deterministically rewritten by
                    # WAL replay and need no repair.)
                    if self.replica_count == 1:
                        raise  # no peer to repair from: fail-stop loudly
                    tracer.count("mark.open_grid_corrupt")
                    log.warning(
                        "replica %d: corrupt checkpoint-referenced grid "
                        "block at open — fetching via block sync",
                        self.replica,
                    )
                    resume_block_sync = snapshot.block_checksums(blob)
                    snapshot.install(
                        self, blob, rebuild_bloom=False,
                        block_cks_map=resume_block_sync,
                    )
            # The encoded free set covers content blocks only; the
            # trailer's own (per-replica) blocks are re-marked from the
            # superblock reference.
            self._mark_trailer_allocated()

        self.journal.recover(self.cluster)
        self.journal.flush_dirty()
        self.op = max(self.journal.highest_op(), st.op_checkpoint)

        replayed = 0
        if resume_block_sync is None:
            # Re-execute contiguous committed prepares beyond the checkpoint.
            replay_to = min(self.commit_max, self.op)
            faulted = False
            for op in range(st.op_checkpoint + 1, replay_to + 1):
                msg = self.journal.read_prepare(op)
                if msg is None:
                    break
                if not self._replay_exec(msg, op):
                    faulted = True
                    break
                replayed += 1
            if self.replica_count == 1 and not faulted:
                # Single replica: every durable prepare is committable.
                for op in range(self.commit_min + 1, self.op + 1):
                    msg = self.journal.read_prepare(op)
                    if msg is None:
                        self.op = op - 1  # torn tail — truncate
                        break
                    if not self._replay_exec(msg, op):
                        break
                    replayed += 1
                self.commit_max = max(self.commit_max, self.commit_min)
        if self.replica_count == 1:
            self.status = STATUS_NORMAL
        else:
            # A restarted replica must learn the cluster's current view
            # before serving (reference .recovering, replica.zig:36-50):
            # acting as primary of a stale view would evict live clients
            # and serve stale state.
            self.status = STATUS_RECOVERING
            self.recovering_since = self.tick_count
        if resume_block_sync is not None:
            self._begin_block_sync(resume_block_sync)
        # Recovered journal ops not yet re-committed gate session judgement
        # the same way a new primary's inherited suffix does.
        self._eviction_floor = self.op

        # Recovery lifecycle stamps (docs/CHAOS.md): WAL-replay phase done;
        # the caught-up detector in _recovery_tick closes the window.
        replay_s = _time.perf_counter() - t_open  # tidy: allow=wall-clock — recovery observability only, never reaches replicated state
        self.recovery_stats = {
            "wal_replay_ops": replayed,
            "wal_replay_s": round(replay_s, 6),
            "replay_ops_per_s": (
                round(replayed / replay_s, 1) if replay_s > 0 and replayed
                else 0.0
            ),
        }
        tracer.observe("recovery.wal_replay", int(replay_s * 1e9))
        tracer.gauge("vsr.recovery.wal_replay_ops", replayed)
        tracer.gauge("vsr.recovery.wal_replay_s", round(replay_s, 6))
        tracer.gauge(
            "vsr.recovery.replay_ops_per_s",
            self.recovery_stats["replay_ops_per_s"],
        )
        self._recovery_active = True
        self._recovery_t0 = t_open
        self._recovery_progress_tick = self.tick_count
        self._recovery_progress_commit = self.commit_min
        self._recovery_stall_tripped = False
        # Failover-timeline gauges (docs/CHAOS.md): which view this
        # replica speaks and whether it is the one serving — a chaos
        # harness scrapes these off /metrics to time an election.
        tracer.gauge("vsr.view", self.view)
        tracer.gauge("vsr.is_primary", int(self.is_primary))
        self.on_event("open", self)

    def _replay_exec(self, msg: Message, op: int) -> bool:
        """Replay one committed prepare at boot. False when a corrupt grid
        block (latent sector error in an LSM block an op reads lazily)
        stopped it: grid repair is initiated — the retry ticks push the
        request once connections form; a solo replica fail-stops inside
        _begin_grid_repair. Execute-phase faults leave the op uncommitted
        (cleanly re-executed after repair); finish-phase faults mark
        _finish_pending so the beat RESUMES, never re-runs."""
        try:
            self._execute(msg)
        except GridReadFault as fault:
            log.warning(
                "replica %d: corrupt grid block at op %d during boot "
                "replay — repairing from a peer after joining",
                self.replica, op,
            )
            tracer.count("mark.open_replay_fault")
            self._begin_grid_repair(fault)
            return False
        self.commit_min = op  # tidy: monotonic=commit_min — boot replay walks contiguously upward from op_checkpoint
        try:
            self._finish_commit()
        except GridReadFault as fault:
            tracer.count("mark.open_replay_fault")
            self._finish_pending = True
            self._begin_grid_repair(fault)
            return False
        return True

    # ------------------------------------------------------------------
    # ticks / timeouts

    def tick(self) -> None:
        if self.retired:
            return
        self.tick_count += 1
        if hasattr(self.time, "tick"):
            self.time.tick()  # replica-owned deterministic time
        self.clock.tick()
        if self.replica_count > 1 and self.tick_count % PING_TIMEOUT == 0:
            self._send_clock_pings()
        self._sync_tick()
        self._grid_repair_tick()
        self._recovery_tick()
        if self.status == STATUS_NORMAL:
            if self.is_primary:
                if self.tick_count - self.last_commit_sent_tick >= COMMIT_HEARTBEAT_TIMEOUT:
                    self._send_commit_heartbeat()
                self._retry_pipeline()
                if (
                    self.config.admission_p99_ms > 0
                    and self.tick_count % ADMISSION_CHECK_TICKS == 0
                    and tracer.enabled()
                ):
                    # Windowed perceived p99 (ops since the last check):
                    # recovers when the overload passes, so shedding
                    # disarms — a lifetime-running p99 would stay tripped
                    # forever after one burst. None = EMPTY window (a
                    # total stall finalizes no ops exactly when latency
                    # is worst): hold the current state, never fail open.
                    p99 = tracer.perceived_p99_ms(self._adm_p99_state)
                    if p99 is None:
                        shed = self._latency_shed
                    else:
                        shed = p99 > self.config.admission_p99_ms
                    if shed != self._latency_shed:
                        self._latency_shed = shed
                        tracer.count(
                            "vsr.admission.latency_arm" if shed
                            else "vsr.admission.latency_disarm"
                        )
            else:
                if self.tick_count - self.last_heartbeat_tick >= NORMAL_HEARTBEAT_TIMEOUT:
                    self._vote_view_change(self._normal_timeout_view())
                self._repair_gaps()
        elif self.status == STATUS_VIEW_CHANGE:
            if self.tick_count - self.last_heartbeat_tick >= VIEW_CHANGE_TIMEOUT:
                self._vote_view_change(self.view + 1)
        elif self.status == STATUS_RECOVERING:
            self._recovering_tick()

    # Recovery-stall flight-recorder threshold, in ticks without commit
    # (or block-fetch) progress while recovery is active: ~15 s at the
    # production server's 10 ms tick. Deterministic (tick-counted), so the
    # simulator's virtual time never wall-clock-flakes it.
    RECOVERY_STALL_TICKS = 1500

    def _recovery_state_code(self) -> int:
        """The vsr.recovery_state gauge value (docs/CHAOS.md taxonomy)."""
        if self._block_sync is not None:
            return RECOVERY_STATE_BLOCK_SYNC
        if self._sync is not None:
            return RECOVERY_STATE_SYNC
        if self._grid_repair is not None or self._finish_pending:
            return RECOVERY_STATE_GRID_REPAIR
        if self.status == STATUS_VIEW_CHANGE:
            return RECOVERY_STATE_VIEW_CHANGE
        if self.status == STATUS_RECOVERING:
            return RECOVERY_STATE_DISCOVER
        if self._recovery_active and self.commit_min < self.commit_max:
            return RECOVERY_STATE_CATCH_UP
        return RECOVERY_STATE_NORMAL

    def _recovery_tick(self) -> None:
        """Recovery lifecycle bookkeeping (docs/CHAOS.md): maintain the
        vsr.recovery_state gauge, detect caught-up — the first moment
        after a restart the replica stands at the cluster tip with no
        sync/repair gate active — and arm a flight-recorder dump when a
        recovery stalls without progress (the post-hoc causality window
        for a replica that never comes back)."""
        code = self._recovery_state_code()
        if code != self._recovery_gauge_last:
            self._recovery_gauge_last = code
            tracer.gauge("vsr.recovery_state", code)
        if not self._recovery_active:
            return
        progressed = self.commit_min > self._recovery_progress_commit
        if self._block_sync is not None:
            fetched = self._block_sync.get("fetched", 0)
            if fetched != self._recovery_progress_fetch:
                self._recovery_progress_fetch = fetched
                progressed = True
        if progressed:
            self._recovery_progress_commit = self.commit_min
            self._recovery_progress_tick = self.tick_count
        if code == RECOVERY_STATE_NORMAL:
            import time as _time

            t = _time.perf_counter() - self._recovery_t0  # tidy: allow=wall-clock — recovery observability only, never reaches replicated state
            self.recovery_stats["time_to_rejoin_s"] = round(t, 6)
            tracer.gauge("vsr.recovery.time_to_rejoin_s", round(t, 6))
            tracer.observe("recovery.rejoin", int(t * 1e9))
            tracer.count("recovery.caught_up")
            self._recovery_active = False
            log.info(
                "replica %d: recovery caught up at op %d "
                "(%.3fs since open, %d ops replayed)",
                self.replica, self.commit_min, t,
                int(self.recovery_stats.get("wal_replay_ops", 0)),
            )
            return
        if (
            not self._recovery_stall_tripped
            and self.tick_count - self._recovery_progress_tick
            > self.RECOVERY_STALL_TICKS
        ):
            self._recovery_stall_tripped = True
            tracer.count("mark.recovery_stall")
            tracer.flight_trip(
                f"recovery stall: replica {self.replica} made no commit "
                f"progress for {self.tick_count - self._recovery_progress_tick} "
                f"ticks (state={code}, commit_min={self.commit_min}, "
                f"commit_max={self.commit_max})"
            )

    RECOVERING_PING_INTERVAL = 20
    RECOVERING_ELECTION_WAIT = 120

    def _recovering_tick(self) -> None:
        if self.tick_count % self.RECOVERING_PING_INTERVAL == 0:
            self._send_clock_pings()
        normal_views = [v for v, ok in self._recovery_pongs.values() if ok]
        if normal_views:
            # An active view exists — adopt it via request_start_view.
            self._catch_up(max(max(normal_views), self.view))
            return
        # Nobody is normal (whole-cluster restart): once a view-change
        # quorum of equally-lost replicas is visible, elect a fresh view.
        waited = self.tick_count - self.recovering_since
        if (
            waited >= self.RECOVERING_ELECTION_WAIT
            and len(self._recovery_pongs) + 1 >= self.quorum_view_change
            and self.tick_count % self.RECOVERING_PING_INTERVAL == 0
        ):
            views = [v for v, _ in self._recovery_pongs.values()]
            self._vote_view_change(max([self.view, *views]) + 1)

    def peer_unmapped(self, replica: int) -> None:
        """A peer connection unmapped (net/bus.py): retire that peer's
        gauge family (`vsr.peer.<r>.*` — replication lag, clock offset,
        RTT) and drop its clock sample window. The registry must stay
        size-stable across connection churn — a dead peer serving stale
        gauges on every scrape is the same leak class as per-conn
        send-queue gauges. Counters and histograms are keyed by
        replica index (bounded) and keep their history."""
        self.clocksync.retire(replica)
        tracer.remove_gauges_prefix(f"vsr.peer.{replica}.")

    # ------------------------------------------------------------------
    # message dispatch

    def on_message(self, msg: Message) -> None:
        if self.retired:
            return
        # `verified` = both MACs already checked at the bus ingress (C
        # scan or read_message) — same bytes, same answer, so the defense
        # re-verify only runs for messages that arrived another way (the
        # packet simulator, unit harnesses, direct embedders).
        if not (msg.verified or msg.verify()):
            return
        h = msg.header
        if h["cluster"] != self.cluster:
            return
        cmd = h["command"]
        handler = {
            Command.REQUEST: self.on_request,
            Command.PREPARE: self.on_prepare,
            Command.PREPARE_OK: self.on_prepare_ok,
            Command.COMMIT: self.on_commit,
            Command.START_VIEW_CHANGE: self.on_start_view_change,
            Command.DO_VIEW_CHANGE: self.on_do_view_change,
            Command.START_VIEW: self.on_start_view,
            Command.REQUEST_START_VIEW: self.on_request_start_view,
            Command.REQUEST_PREPARE: self.on_request_prepare,
            Command.REQUEST_HEADERS: self.on_request_headers,
            Command.HEADERS: self.on_headers,
            Command.REQUEST_SYNC_CHECKPOINT: self.on_request_sync_checkpoint,
            Command.SYNC_CHECKPOINT: self.on_sync_checkpoint,
            Command.REQUEST_BLOCKS: self.on_request_blocks,
            Command.BLOCK: self.on_block,
            Command.PING: self.on_ping,
            Command.PONG: self.on_pong,
        }.get(cmd)
        if handler is not None:
            handler(msg)

    # --- normal protocol ------------------------------------------------

    def _send_clock_pings(self) -> None:
        """Periodic clock-offset sampling (reference ping_timeout,
        replica.zig:2535): ping.op carries our monotonic send stamp."""
        ping = hdr.make(
            Command.PING, self.cluster, replica=self.replica, view=self.view,
            op=self.clock.ping_timestamp(),
        )
        m = Message(ping).seal()
        for r in range(self.replica_count):
            if r != self.replica:
                self.bus.send_to_replica(r, m)

    def on_ping(self, msg: Message) -> None:
        # pong echoes the ping's monotonic stamp (op) and carries our wall
        # time (timestamp) — the clock's offset sample (clock.zig learn).
        pong = hdr.make(
            Command.PONG, self.cluster, replica=self.replica, view=self.view,
            request=1 if self.status == STATUS_NORMAL else 0,
            op=msg.header["op"],
            timestamp=self.time.realtime_ns(),
        )
        self.bus.send_to_replica(msg.header["replica"], Message(pong).seal())

    def on_pong(self, msg: Message) -> None:
        h = msg.header
        m1 = self.time.monotonic_ns()
        self.clock.learn(
            int(h["replica"]), m0=int(h["op"]), t_remote=int(h["timestamp"]),
            m1=m1,
        )
        if tracer.enabled():
            # Telemetry half of the same sample (vsr/clocksync.py):
            # per-peer offset/RTT gauges + the cluster skew bound.
            # Estimation only — never feeds the state machine.
            self.clocksync.learn(
                int(h["replica"]), m0=int(h["op"]),
                t_remote=int(h["timestamp"]), m1=m1,
                realtime_ns=self.time.realtime_ns(), monotonic_ns=m1,
            )
        if self.status != STATUS_RECOVERING:
            return
        self._recovery_pongs[h["replica"]] = (h["view"], h["request"] == 1)

    def on_request(self, msg: Message) -> None:
        if not self.is_primary:
            # Forward to the primary (clients may be out of date).
            if self.status == STATUS_NORMAL:
                self.bus.send_to_replica(self.primary_index(self.view), msg)
            return
        h = msg.header
        if not self._request_valid(h, msg.body):
            return
        client = h["client"]
        sess = self.clients.get(client)

        if h["operation"] == Operation.RECONFIGURE:
            # Operator-issued membership change (client 0, no session):
            # dedupe against in-flight AND already-applied copies, then
            # commit like any op. (Commit is idempotent regardless — the
            # promoted_at_op guard makes duplicates no-ops — this just
            # avoids wasting ops.)
            rec = np.frombuffer(msg.body, dtype=RECONFIGURE_DTYPE)
            pair = (
                (int(rec[0]["standby_index"]), int(rec[0]["target_index"]))
                if len(rec) else None
            )
            inflight = any(
                e.message.header["operation"] == Operation.RECONFIGURE
                for e in self.pipeline
            ) or any(
                q.header["operation"] == Operation.RECONFIGURE
                for q in self.request_queue
            )
            if not inflight and pair not in self.reconfigures_applied:
                self._append_request(msg)
            return

        if h["operation"] == Operation.REGISTER:
            if sess is None:
                # Session is created when the register op COMMITS (it is
                # replicated state — reference client_sessions.zig); guard
                # against duplicate registers already queued, in the
                # pipeline, OR in the commit stage (committed, session not
                # yet applied — a resend there would register twice).
                if client not in self._queued_req and not any(
                    e.message.header["client"] == client
                    and e.message.header["operation"] == Operation.REGISTER
                    for e in self.pipeline
                ) and not any(
                    job["msg"].header["client"] == client
                    and job["msg"].header["operation"] == Operation.REGISTER
                    for job in self._staged
                ):
                    self._append_request(msg)
            else:
                self._reply_cached(client, sess)
            return

        if sess is None:
            if self.commit_min < self._eviction_floor:
                # A just-elected primary still committing the suffix it
                # INHERITED from the previous view has a BEHIND client
                # table — the session's register may be in those ops.
                # Judging it now would evict a live client permanently
                # (VOPR seed 227); drop instead, the client resends after
                # catch-up. The floor is the election-time op, so steady-
                # state pipelining never suppresses genuine evictions.
                return
            self.bus.send_to_client(client, hdr.make_sealed(
                Command.EVICTION, self.cluster, client=client,
                replica=self.replica, view=self.view,
            ))
            return
        if h["request"] <= sess.request:
            if h["request"] == sess.request and sess.reply is not None:
                self.bus.send_to_client(client, sess.reply)
            return
        # Drop resends of requests still in flight (uncommitted in the
        # pipeline or queued) — preparing them twice would execute twice.
        # The queued check is the O(1) map, not a queue scan.
        queued_req = self._queued_req.get(client)
        if queued_req is not None:
            if queued_req >= h["request"]:
                return  # resend of the queued entry
            # A NEWER request while one still waits: the client broke the
            # one-in-flight session contract (or a BUSY retry raced a
            # late admit). Fair drain: one backlog slot per session — a
            # hot session is shed, it cannot starve the rest.
            self._shed_request(h, "session_slot")
            return
        for pending in self.pipeline:
            ph = pending.message.header
            if ph["client"] == client and ph["request"] >= h["request"]:
                return
        # Same for ops in the commit stage: committed but not yet applied
        # (sess.request still lags), so a resend here would prepare —
        # and execute — the request a second time.
        for job in self._staged:
            jh = job["msg"].header
            if jh["client"] == client and jh["request"] >= h["request"]:
                return
        self._append_request(msg)

    def _request_valid(self, h: Header, body: bytes) -> bool:
        """Size/shape validation before any state changes (a malformed
        request must never wedge the prepare path)."""
        if hdr.HEADER_SIZE + len(body) > self.config.message_size_max:
            return False
        operation = h["operation"]
        if operation in (Operation.GET_ACCOUNT_TRANSFERS, Operation.GET_ACCOUNT_HISTORY):
            # Exactly one filter record — a zero-event body would otherwise
            # fault every replica at commit (client-triggerable poison pill).
            if len(body) != types.ACCOUNT_FILTER_DTYPE.itemsize:
                return False
        elif operation in (Operation.QUERY_ACCOUNTS, Operation.QUERY_TRANSFERS):
            if len(body) not in (
                types.QUERY_FILTER_DTYPE.itemsize,
                types.QUERY_FILTER_V2_DTYPE.itemsize,
            ):
                return False
        elif operation >= 128:
            ev_size = _event_dtype(operation).itemsize
            if len(body) % ev_size != 0:
                return False
            if len(body) // ev_size > self.config.batch_max:
                return False
        elif operation == Operation.REGISTER:
            if len(body) != 0:
                return False
        elif operation == Operation.RECONFIGURE:
            if len(body) != RECONFIGURE_DTYPE.itemsize:
                return False
        else:
            return False
        return True

    def _reply_cached(self, client: int, sess: ClientSession) -> None:
        if sess.reply is not None:
            self.bus.send_to_client(client, sess.reply)

    def _evict_lru_client(self) -> None:
        """Evict the least-recently-active session in O(1): dict insertion
        order is maintained as recency order by _execute_tail's
        move-to-end, so the first key is the LRU session (the old
        min-over-session scan was O(n) per register at the 10k-session
        front door, and evicted by REGISTRATION age — punishing the
        longest-lived session instead of the idlest)."""
        lru = next(iter(self.clients))
        del self.clients[lru]
        tracer.count("vsr.session_evictions")

    def _shed_request(self, h: Header, reason: str) -> None:
        """Admission shed: answer with a retryable BUSY (the client backs
        off and resends — distinct from EVICTION, which kills the
        session). Shedding at the door costs one header; queueing past
        saturation costs unbounded queue-wait for everyone."""
        tracer.count("vsr.sheds")
        tracer.count(f"vsr.sheds.{reason}")
        self.bus.send_to_client(h["client"], hdr.make_sealed(
            Command.BUSY, self.cluster, client=h["client"],
            request=h["request"], replica=self.replica, view=self.view,
        ))

    def _admission_full(self) -> Optional[str]:
        """Shed reason when the door is saturated, else None. Queue-depth
        bound always armed; the perceived-p99 bound only when configured
        (its state is refreshed at tick granularity, see tick())."""
        if len(self.request_queue) >= self.config.request_queue_max:
            return "queue_full"
        if self._latency_shed:
            return "latency"
        return None

    def _append_request(self, msg: Message) -> None:
        if msg.lifecycle is None and tracer.enabled():
            # In-process embedders (simulator, profile_e2e) bypass the
            # bus ingress stamp — arrival is acceptance here.
            msg.lifecycle = tracer.op_begin()
            tracer.op_stamp(msg.lifecycle, tracer.OP_ARRIVE)
        if len(self.pipeline) >= self.config.pipeline_max:
            h = msg.header
            if h["operation"] != Operation.RECONFIGURE:
                # RECONFIGURE is exempt: operator control plane, already
                # bounded to one in-flight copy by its dedupe.
                reason = self._admission_full()
                if reason is not None:
                    self._shed_request(h, reason)
                    return
            self.request_queue.append(msg)
            self._queued_req[int(h["client"])] = int(h["request"])
            return
        self._primary_prepare(msg)

    def _primary_prepare(self, request: Message) -> None:
        assert self.is_primary
        self.op += 1
        rh = request.header
        n_events = (
            (rh["size"] - hdr.HEADER_SIZE)
            // _event_dtype(
                rh["operation"], int(rh["size"]) - hdr.HEADER_SIZE
            ).itemsize
            if rh["operation"] >= 128
            else 0
        )
        sm = self.state_machine
        # journal.timestamp_max floors against in-flight (uncommitted)
        # prepares adopted across a recovery/view change — a checkpoint
        # records only the COMMITTED timestamp high-water, so without this
        # floor a recovered primary could re-assign a timestamp already
        # used by an op it later commits.
        base = max(
            sm.prepare_timestamp, self.journal.timestamp_max, self._realtime_ns()
        )
        timestamp = base + n_events if n_events else base + 1
        sm.prepare_timestamp = timestamp

        prev = self.journal.headers.get(self.journal.slot_for_op(self.op - 1))
        ph = hdr.make(
            Command.PREPARE, self.cluster,
            view=self.view, op=self.op, commit=self.commit_min,
            timestamp=timestamp, replica=self.replica,
            operation=rh["operation"], client=rh["client"], request=rh["request"],
            parent=(prev["checksum"] if prev is not None else 0),
        )
        # Checksum once: the request body was MAC-verified on ingress and is
        # reused byte-for-byte as the prepare body.
        prepare = Message(ph, request.body).seal_with_body_checksum(
            request.header["checksum_body"]
        )
        # The lifecycle record moves from the request onto its prepare:
        # request-queue wait ends here, the prepare/WAL leg begins.
        lc = prepare.lifecycle = request.lifecycle
        tracer.op_stamp(lc, tracer.OP_PREPARE)
        tracer.op_meta(
            lc, op=self.op, client=int(rh["client"]),
            request=int(rh["request"]), operation=int(rh["operation"]),
            n_events=int(n_events),
        )
        entry = Pipeline(prepare)
        self.pipeline.append(entry)
        # Cluster plane: open the op's peer window at broadcast (lc is
        # None when tracing is off — the whole plane then costs this one
        # None check per prepare).
        if lc is not None:
            self.peer_stats.broadcast(self.op, lc)
        if self.wal_writer is None:
            self.journal.write_prepare(prepare, lc=lc)
            entry.ok_from.add(self.replica)
            self._peer_ack(self.op, self.replica)
            self._replicate_chain(prepare)
            self._check_pipeline_quorum()
        else:
            # Async WAL: queue the durable body write on the writer thread,
            # replicate NOW so the network overlaps the DMA (reference
            # replica.zig:3034 starts replication before its WAL write
            # completes), and grant our own prepare_ok only once the write
            # lands (ack-after-durable).
            op, cks, view = self.op, ph["checksum"], self.view
            self.journal.write_prepare_async(
                prepare, lambda: self._on_wal_durable(op, cks, view), lc=lc
            )
            self._replicate_chain(prepare)

    def _on_wal_durable(self, op: int, checksum: int, view: int) -> None:
        """Group-fsync landed for our own prepare at `op`: grant the
        primary's self prepare_ok (the durable half of the ack). Stale
        callbacks — the view moved on, or the entry was re-proposed with a
        different seal — are dropped, mirroring on_prepare_ok's guards:
        committing in a view that has moved on could apply an op the new
        view never chose."""
        if (
            self.status != STATUS_NORMAL
            or not self.is_primary
            or view != self.view
        ):
            return
        # Stamp BEFORE the pipeline scan (like on_prepare_ok): when both
        # backups acked first, quorum already popped the entry — and a
        # local group-fsync landing AFTER the remote quorum is exactly
        # the self-straggler the attribution exists to diagnose.
        self._peer_ack(op, self.replica)
        for entry in self.pipeline:
            h = entry.message.header
            if h["op"] == op and h["checksum"] == checksum:
                entry.ok_from.add(self.replica)
                break
        self._check_pipeline_quorum()

    def _backup_wal_durable(self, h: Header) -> None:
        """Group-fsync landed for a backup's accepted prepare: send the
        prepare_ok we deferred at accept time."""
        if self.status != STATUS_NORMAL or h["view"] != self.view:
            return  # view moved on while the fsync was in flight
        self._send_prepare_ok(h)
        self._commit_journal(h["commit"])

    def _retry_pipeline(self) -> None:
        if not self.pipeline:
            return
        if self.tick_count % PREPARE_TIMEOUT == 0:
            for entry in self.pipeline:
                for r in range(self.replica_count):
                    if r not in entry.ok_from:
                        self.bus.send_to_replica(r, entry.message)

    def on_prepare(self, msg: Message) -> None:
        h = msg.header
        if self.status != STATUS_NORMAL:
            # A prepare at OUR view-change view can only come from a primary
            # serving that view normally: the view change completed without
            # us (our START_VIEW was lost) — adopt its outcome instead of
            # wedging (VOPR seed 161).
            if self.status == STATUS_VIEW_CHANGE and h["view"] >= self.view:
                self._catch_up_throttled(h["view"])
            return
        op = h["op"]
        if op <= self.superblock.state.op_checkpoint:
            return  # predates the durable checkpoint; never rewrite history
        if h["view"] < self.view:
            # A repair response: prepares keep their original view. Accept
            # into the journal if the slot is missing or holds content the
            # winning log rejected, but never prepare_ok an old view
            # (reference on_repair, replica.zig:1646).
            if op > self.op or not self.journal.can_write(op):
                return
            target = self.repair_target.get(op)
            if target is None:
                # After a restart the in-memory map is empty, but durable
                # targets live on as faulty header-ring slots: the ring
                # header is the content contract for the arriving body.
                slot = self.journal.slot_for_op(op)
                if slot in self.journal.faulty:
                    ring = self.journal.headers.get(slot)
                    if ring is not None and ring["op"] == op:
                        target = ring
            if target is not None and not self._content_eq(h, target):
                if not (op in self.repair_target_weak and h["view"] > target["view"]):
                    return  # not the content the winning log requires
                # A weak (HEADERS-derived) target is superseded by genuinely
                # newer-view content — the weak header was stale.
            if not self._journal_has_target(op) or self.journal.read_prepare(op) is None:
                # Hole, torn body, or stale content: install the repair.
                self.journal.write_prepare(msg)
            self._drop_target(op)
            self._commit_journal(self.commit_max)
            if self.is_primary and self.op > self.commit_min:
                self._reproposal_pipeline(self.view)
            return
        if h["view"] > self.view:
            self._catch_up(h["view"])  # lagging: ask the new primary for the view
            return
        self.last_heartbeat_tick = self.tick_count
        if op <= self.op:
            existing = self.journal.read_prepare(op)
            if existing is not None and existing.header["checksum"] == h["checksum"]:
                self._drop_target(op)
                # Ack-after-durable even for duplicates: the original body
                # write may still be queued on the WAL writer — acking
                # before it lands would let the primary count a quorum an
                # untimely power loss could revoke. barrier() fires after
                # every previously queued write is durable.
                if self.wal_writer is None:
                    self._send_prepare_ok(h)
                    self._commit_journal(h["commit"])
                else:
                    self.wal_writer.barrier(lambda: self._backup_wal_durable(h))
                return
            if (existing is None or h["view"] >= existing.header["view"]) and (
                self.journal.can_write(op)
            ):
                # Re-proposed in a newer view (post view-change): overwrite.
                self.journal.write_prepare(msg)
                self._drop_target(op)
                self._send_prepare_ok(h)
                self._commit_journal(h["commit"])
            return
        if op != self.op + 1:
            # Gap: remember commit target; repair will fetch missing ops.
            # Still forward down the chain (reference replicate() forwards
            # on receipt): our gap must not starve downstream replicas of
            # fresh prepares.
            self._replicate_chain(msg)
            self.commit_max = max(self.commit_max, h["commit"])
            self._repair_gaps(target=op)
            return
        self.op = op
        if self.wal_writer is None:
            self.journal.write_prepare(msg)
            self._replicate_chain(msg)
            self._send_prepare_ok(h)
            self._commit_journal(h["commit"])
        else:
            # Queue the durable write, forward down the chain immediately,
            # and defer prepare_ok to completion (ack-after-durable).
            self.journal.write_prepare_async(
                msg, lambda: self._backup_wal_durable(h)
            )
            self._replicate_chain(msg)

    def _replicate_chain(self, prepare: Message) -> None:
        """Forward a freshly-accepted prepare down the replication chain
        (reference replicate, replica.zig:6068): the primary sends each
        prepare ONCE to its ring successor and every backup forwards to
        the next replica until the ring would wrap back to the primary —
        primary egress is one copy per prepare instead of n-1. Chain-break
        liveness: while an op is UNCOMMITTED the primary's pipeline retry
        fan-out re-sends it directly to every replica whose prepare_ok is
        missing; once quorum commits (and the pipeline entry pops), a
        still-missing tail replica catches up via the commit heartbeat →
        _repair_gaps → REQUEST_PREPARE path instead."""
        total = self.replica_count + self.standby_count
        if total <= 1:
            return
        with tracer.span("stage.replicate"):
            self._replicate_chain_inner(prepare)

    def _replicate_chain_inner(self, prepare: Message) -> None:
        total = self.replica_count + self.standby_count
        if self.is_standby:
            # Standby sub-chain: forward to the next standby, if any.
            if self.replica + 1 < total:
                self.bus.send_to_replica(self.replica + 1, prepare)
            return
        v = prepare.header["view"]
        pos = (self.replica - self.primary_index(v)) % self.replica_count
        if pos + 1 >= self.replica_count:
            # Active-chain tail: instead of wrapping to the primary, extend
            # the chain into the standbys (reference: standbys sit at the
            # end of the replication chain).
            if self.standby_count:
                self.bus.send_to_replica(self.replica_count, prepare)
            return
        self.bus.send_to_replica((self.replica + 1) % self.replica_count, prepare)

    def _send_prepare_ok(self, prepare_header: Header) -> None:
        if self.is_standby:
            return  # passive: journals + commits, never acks toward quorum
        ok = hdr.make(
            Command.PREPARE_OK, self.cluster,
            view=self.view, op=prepare_header["op"],
            parent=prepare_header["checksum"],
            replica=self.replica, timestamp=prepare_header["timestamp"],
            epoch=self.config_epoch,
        )
        tracer.count("vsr.prepare_ok_sent")
        self.bus.send_to_replica(self.primary_index(self.view), Message(ok).seal())

    def _peer_ack(self, op: int, replica: int) -> None:
        """Cluster-plane ack stamp (vsr/peerstats.py): per-peer
        prepare_ok latency, quorum completion/straggler attribution,
        and the per-peer acked-op high-water. Telemetry only."""
        if tracer.enabled():
            self.peer_stats.ack(op, replica, self.quorum_replication)

    def on_prepare_ok(self, msg: Message) -> None:
        if not self.is_primary or msg.header["view"] != self.view:
            return
        if msg.header["epoch"] < self.slot_epoch.get(int(msg.header["replica"]), 0):
            return  # stale occupant of a reassigned slot: no quorum weight
        op = msg.header["op"]
        # Stamp BEFORE the pipeline scan: a straggler's ack arrives
        # after quorum already popped the entry, and attributing exactly
        # those arrivals is the point (the tracker validates op).
        self._peer_ack(int(op), int(msg.header["replica"]))
        for entry in self.pipeline:
            if entry.message.header["op"] == op:
                if msg.header["parent"] == entry.message.header["checksum"]:
                    entry.ok_from.add(msg.header["replica"])
                break
        self._check_pipeline_quorum()

    def _check_pipeline_quorum(self) -> None:
        while self.pipeline:
            entry = self.pipeline[0]
            if len(entry.ok_from) < self.quorum_replication:
                break
            op = entry.message.header["op"]
            if op <= self.commit_staged:
                # Already committed through the journal path (e.g. while a
                # grid repair had the pipeline gated): drop the stale head
                # — the client recovers its reply from the session cache
                # on resend; executing again would double-apply.
                self.pipeline.pop(0)
                continue
            if op != self.commit_staged + 1:
                # Earlier ops (from before a view change) must commit through
                # the journal first; _commit_journal re-checks the pipeline.
                break
            if (
                self._grid_repair is not None
                or self._finish_pending
                or self._checkpoint_pending
            ):
                break  # a block repair is in flight: commits are gated
            if self.executor is not None:
                # Overlapped stage: hand the committed prepare to the
                # executor (reply sent at completion) and keep pumping.
                if not self._stage_can_submit():
                    break
                self.pipeline.pop(0)
                self.commit_max = max(self.commit_max, op)
                self._stage_submit(entry.message, op, entry)
                continue
            self.pipeline.pop(0)
            self.commit_max = max(self.commit_max, op)
            lc = entry.message.lifecycle
            # Serial inline commit: quorum reached IS the commit submit,
            # and execution starts immediately (queue.commit ≈ 0).
            tracer.op_stamp(lc, tracer.OP_COMMIT_SUBMIT)
            tracer.op_stamp(lc, tracer.OP_EXEC_START)
            try:
                reply = self._execute(entry.message)
            except GridReadFault as fault:
                # Every grid read in an op precedes its first durable
                # mutation (prefetch/dup-check/lazy-oracle reads come
                # first; store paths only write), so the op is cleanly
                # retryable: requeue it and repair the one block.
                self.pipeline.insert(0, entry)
                self._begin_grid_repair(fault)
                break
            self.commit_min = op  # tidy: monotonic=commit_min — inline commit loop pops the pipeline in op order from commit_min+1
            tracer.op_stamp(lc, tracer.OP_EXEC_END)
            if reply is not None:
                # Reply first: it depends only on validate+post, and
                # asyncio pushes it to the socket synchronously when the
                # buffer is empty — the client pipelines its next request
                # against our store/compaction work below.
                tracer.count("vsr.replies")
                self.bus.send_to_client(entry.message.header["client"], reply)
                tracer.op_stamp(lc, tracer.OP_REPLY)
            tracer.op_finish(lc)
            try:
                self._finish_commit(lc)
            except GridReadFault as fault:
                # Already committed; the deferred store/beat must finish
                # after repair BEFORE any further op executes.
                self._finish_pending = True
                self._finish_lc = lc
                self._begin_grid_repair(fault)
                break
            if not self._checkpoint_guarded():
                break
        while self.request_queue and len(self.pipeline) < self.config.pipeline_max:
            queued = self.request_queue.popleft()
            self._queued_req.pop(int(queued.header["client"]), None)
            self._primary_prepare(queued)
        if tracer.enabled():
            # Pipeline-pressure gauges: prepare pipeline, client request
            # backlog, and ops staged through the commit executor.
            tracer.gauge("vsr.pipeline.depth", len(self.pipeline))
            tracer.gauge("vsr.request_queue.depth", len(self.request_queue))
            tracer.gauge("vsr.stage.depth", len(self._staged))
            # Per-peer replication-lag gauges, re-sampled per commit
            # round: primary tip vs each peer's highest acked op
            # (primary only — a backup's ack table is stale zeros).
            if self.is_primary:
                self.peer_stats.commit_sample(self.op, self.commit_min)

    def _send_commit_heartbeat(self) -> None:
        self.last_commit_sent_tick = self.tick_count
        ch = hdr.make(
            Command.COMMIT, self.cluster,
            view=self.view, commit=self.commit_min, replica=self.replica,
        )
        m = Message(ch).seal()
        for r in range(self.replica_count + self.standby_count):
            if r != self.replica:
                self.bus.send_to_replica(r, m)

    def on_commit(self, msg: Message) -> None:
        h = msg.header
        if h["view"] > self.view:
            # A commit heartbeat from a newer view: we missed a view change
            # (crashed/partitioned through it) — catch up via start_view.
            self._catch_up(h["view"])
            return
        if self.status == STATUS_VIEW_CHANGE and h["view"] == self.view:
            # The view we are changing into is already serving normally —
            # its START_VIEW never reached us. Adopt it (VOPR seed 161).
            self._catch_up_throttled(h["view"])
            return
        if self.status != STATUS_NORMAL or h["view"] != self.view or self.is_primary:
            return
        self.last_heartbeat_tick = self.tick_count
        self._commit_journal(h["commit"])

    def _catch_up(self, view: int) -> None:
        """Request the current view state from the newer view's primary
        (reference request_start_view; replica.zig on_request_start_view).
        Non-disruptive: does not start a view change of its own."""
        self.last_heartbeat_tick = self.tick_count
        self._last_rsv_tick = self.tick_count
        rsv = hdr.make(
            Command.REQUEST_START_VIEW, self.cluster,
            view=view, replica=self.replica,
        )
        self.bus.send_to_replica(self.primary_index(view), Message(rsv).seal())

    RSV_THROTTLE = 20

    def _catch_up_throttled(self, view: int) -> None:
        """Per-prepare/commit escape hatch: rate-limit the RSV so a loaded
        primary is not flooded with one request per prepare."""
        if self.tick_count - getattr(self, "_last_rsv_tick", -1000) < self.RSV_THROTTLE:
            return
        self._catch_up(view)

    def on_request_start_view(self, msg: Message) -> None:
        # is_primary is False in any non-normal status, so this also
        # rejects RSVs while we are mid-view-change ourselves.
        if not self.is_primary or msg.header["view"] != self.view:
            return
        sv = hdr.make(
            Command.START_VIEW, self.cluster,
            view=self.view, replica=self.replica, op=self.op, commit=self.commit_min,
        )
        body = b"".join(h.to_bytes() for h in self._sv_body_headers())
        self.bus.send_to_replica(msg.header["replica"], Message(sv, body).seal())

    def _commit_journal(self, commit_target: int) -> None:
        self.commit_max = max(self.commit_max, commit_target)
        if self._block_sync is not None:
            # Mid block-sync the LSM tier is incomplete: executing an op
            # could read a grid block that has not arrived yet. Commits
            # resume from _finish_block_sync.
            return
        if (
            self._grid_repair is not None
            or self._finish_pending
            or self._checkpoint_pending
        ):
            return  # a block repair is in flight: commits are gated
        if self.executor is not None:
            # Overlapped stage: feed committable journal ops to the
            # executor in op order; completions advance commit_min.
            while self.commit_staged < self.commit_max and self._stage_can_submit():
                op = self.commit_staged + 1
                msg = (
                    self.journal.read_prepare(op)
                    if self._journal_has_target(op) else None
                )
                if msg is None:
                    self._repair_gaps(target=op)
                    break
                self._stage_submit(msg, op, None)
        else:
            while self.commit_min < self.commit_max:
                op = self.commit_min + 1
                msg = self.journal.read_prepare(op) if self._journal_has_target(op) else None
                if msg is None:
                    self._repair_gaps(target=op)
                    break
                lc = self._lc_for(msg, op)
                tracer.op_stamp(lc, tracer.OP_COMMIT_SUBMIT)
                tracer.op_stamp(lc, tracer.OP_EXEC_START)
                try:
                    self._execute(msg)
                except GridReadFault as fault:
                    self._begin_grid_repair(fault)
                    break
                self.commit_min += 1
                tracer.op_stamp(lc, tracer.OP_EXEC_END)
                tracer.op_finish(lc)
                self._drop_target(op)
                try:
                    self._finish_commit(lc)
                except GridReadFault as fault:
                    self._finish_pending = True
                    self._finish_lc = lc
                    self._begin_grid_repair(fault)
                    break
                if not self._checkpoint_guarded():
                    break
        if self.is_primary and self.pipeline:
            self._check_pipeline_quorum()

    # --- overlapped commit stage (vsr/pipeline.CommitExecutor) ----------
    #
    # Commit order is FIXED before anything is submitted (quorum on the
    # primary, the commit number on backups); the stage drains strictly in
    # that order, so execution overlaps networking/WAL/quorum accounting
    # without perturbing determinism. Gated states (grid repair, block
    # sync, checkpoint, view change, state sync) quiesce the stage before
    # touching state the executor shares.

    STAGE_QUEUE_MAX = 16  # ops in flight through the stage

    def attach_executor(
        self,
        post: Callable[[Callable[[], None]], None],
        commit_depth: int = 0,
    ) -> None:
        """Wire the overlapped commit stage. `post` schedules a callback
        onto the replica's event loop thread (fail-stop guarded by the
        embedder). Tests and the deterministic simulator never call this:
        executor=None selects the serial inline fallback.

        `commit_depth` sizes the cross-batch dispatch window (0 = the
        state machine's device-aware default)."""
        from tigerbeetle_tpu_torch.vsr.pipeline import CommitExecutor

        assert self.executor is None
        self.commit_depth = self._resolve_commit_depth(commit_depth)
        tracer.gauge("pipeline.commit.depth_config", self.commit_depth)
        self._reply_builder = hdr.ReplyBuilder()
        self.executor = CommitExecutor(
            process=self._stage_process,
            post=post,
            flush=self._stage_flush,
            notify=self._drain_stage_completions,
            # The worker binds the machine's CUDA device (a fresh
            # thread's current device is 0) and launches on its default
            # stream, as the loop and the store stage do: that stream
            # orders the tensors that cross the threads (lazy query
            # runs, deferred store records).
            thread_init=self.state_machine.bind_thread,
        )

    def _resolve_commit_depth(self, requested: int) -> int:
        """Clamp an explicit depth, or pick the adaptive default. The cap
        is the smaller of the protocol's prepare-queue depth and the
        state machine's dispatch window (scratch-ring slots)."""
        from tigerbeetle_tpu_torch.models.state_machine import DISPATCH_WINDOW_MAX

        if not requested:
            requested = self.state_machine.dispatch_depth_default()
        return max(
            1, min(int(requested), self.config.pipeline_max, DISPATCH_WINDOW_MAX)
        )

    # --- deferred LSM store stage (vsr/pipeline.StoreExecutor) ----------
    #
    # Store durability is a pure function of the committed batch: once the
    # reply is out, the op's groove/index writes and its compaction beat
    # can trail commit order on a dedicated thread, as long as jobs drain
    # strictly in op order (grid allocation order — and therefore
    # checkpoint bytes — depends on nothing else). Reads synchronize via
    # StateMachine.store_barrier() (drain-before-read = read-your-writes);
    # checkpoint, state-sync, and block-serve paths quiesce the stage.

    def attach_store_executor(
        self, post: Callable[[Callable[[], None]], None]
    ) -> None:
        """Wire the async store stage. `post` schedules a callback onto
        the replica's event loop thread. Tests and the deterministic
        simulator skip this: store_executor=None keeps store+beat inline
        in _finish_commit."""
        from tigerbeetle_tpu_torch.vsr.pipeline import StoreExecutor

        assert self.store_executor is None
        self.store_executor = StoreExecutor(
            process=self._store_process,
            post=post,
            notify=self._drain_store_faults,
            idle_work=self._store_idle_prefetch,
            thread_init=self.state_machine.bind_thread,  # as the commit stage's
        )
        self.state_machine.attach_store_stage(self.store_executor)

    def _store_idle_prefetch(self) -> bool:
        """Queue-idle poll on the store worker: pull ONE pending device
        query-index run's device→host transfer forward (lsm/tree
        prefetch_lazy_one) so the eventual flush never blocks on the
        device, or — when none is pending — warm one upcoming compaction
        input block into the grid cache (sm.compact_prefetch_one; storm
        jobs only), so a storm's merge beats read hot instead of from
        storage. Both are
        content-neutral and idempotent — materialization is the same
        bytes whenever it happens, and the read-ahead only changes cache
        temperature, never merge order; `self.state_machine` is read per
        call so a state-sync install is picked up naturally."""
        sm = self.state_machine
        if sm.query_rows.prefetch_lazy_one():
            return True
        return sm.compact_prefetch_one()

    def _store_process(self, job: dict) -> Optional[dict]:
        """Worker-thread side: apply one op's coalesced store job, then
        its compaction beat — the exact serial _finish_commit sequence.
        Returns None on success, or the job (fault attached) to park the
        stage on a GridReadFault (corrupt compaction input): the loop
        repairs the block and `resume()`s the SAME job, which skips its
        already-applied store phase and re-enters the beat at the faulted
        stage (sm._beat_stage) — identical to the serial retry."""
        sm = self.state_machine
        lc = job.get("lc")
        tracer.op_stamp(lc, tracer.OP_STORE_START)
        try:
            with tracer.span("stage.store_async"):
                store = job.get("store")
                if store is not None and not job.get("stored"):
                    recs, ts = store
                    with tracer.span("sm.ct.store"):
                        sm._store_new_transfers(recs, ts=ts, add_bloom=False)
                    job["stored"] = True
                # flush=False: this job's store was applied above; the
                # live _deferred_store (if any) is the NEXT op's batch,
                # owned by the commit thread until its own job captures
                # it — it must not be flushed from this thread.
                sm.compact_beat(flush=False)
        except GridReadFault as fault:
            job["fault"] = fault
            return job
        tracer.op_stamp(lc, tracer.OP_STORE_END)
        tracer.op_store_done(lc)
        return None

    def _drain_store_faults(self) -> None:
        """Loop-side fault drainer (the stage's notify): a parked store
        job gates commits exactly like a serial finish-phase fault —
        _finish_pending up, grid repair started, the job held for
        resumption after the block is rewritten."""
        se = self.store_executor
        if se is None:
            return
        while True:
            job = se.pop_done()
            if job is None:
                return
            self._store_resume = job
            self._finish_pending = True
            self._begin_grid_repair(job["fault"])

    def _quiesce_store_stage(self) -> bool:
        """Drain the async store stage (cheap no-op when idle). False
        when it parked on a fault — grid/store state is then incomplete
        and the caller must not read it (repair is in flight)."""
        se = self.store_executor
        if se is None:
            return True
        se.drain()
        return not se.parked

    def _stage_can_submit(self) -> bool:
        if self._stage_quiescing or len(self._staged) >= self.STAGE_QUEUE_MAX:
            return False
        # Checkpoint barrier: once a checkpoint-boundary op is staged,
        # nothing may follow it until its completion ran the checkpoint on
        # a quiescent state machine (the trailer must capture exactly the
        # boundary op's state on every replica).
        if self._staged and (
            self._staged[-1]["op"] % self.config.checkpoint_interval == 0
        ):
            return False
        return True

    def _lc_for(self, msg: Message, op: int):
        """The op's lifecycle record: the one riding the message (primary
        path), or a fresh one for journal-derived commits (backups,
        catch-up) so the execute/store decomposition covers them too —
        their earlier stamps are simply absent."""
        lc = msg.lifecycle
        if lc is None and tracer.enabled():
            h = msg.header
            lc = msg.lifecycle = tracer.op_begin()
            n_events = (
                (int(h["size"]) - hdr.HEADER_SIZE)
                // _event_dtype(
                    h["operation"], int(h["size"]) - hdr.HEADER_SIZE
                ).itemsize
                if h["operation"] >= 128 else 0
            )
            tracer.op_meta(
                lc, op=op, client=int(h["client"]), request=int(h["request"]),
                operation=int(h["operation"]), n_events=n_events,
            )
        return lc

    def _stage_submit(self, msg: Message, op: int, entry: Optional[Pipeline]) -> None:
        assert op == self.commit_staged + 1
        lc = self._lc_for(msg, op)
        tracer.op_stamp(lc, tracer.OP_COMMIT_SUBMIT)
        job = {"op": op, "msg": msg, "entry": entry, "lc": lc}
        self._staged.append(job)
        self.executor.submit(job)

    def _quiesce_commit_stage(self) -> None:
        """Drain the stage and apply its completions inline — after this,
        commit_min reflects every executed op and the executor is idle
        (or parked on a fault, whose completion raises the gates)."""
        if self.executor is None or not self._staged:
            return
        self._stage_quiescing = True
        try:
            while self._staged:
                self.executor.drain()
                self._drain_stage_completions()
                if self.executor.parked:
                    break  # fault: the gate flags take over from here
        finally:
            self._stage_quiescing = False

    def _drain_stage_completions(self) -> None:
        ex = self.executor
        if ex is None:
            return
        while True:
            job = ex.pop_done()
            if job is None:
                return
            if "finish_fault" in job:
                # The op committed (its completion was already applied);
                # its deferred store/beat faulted after the fact and must
                # complete after repair BEFORE any further op.
                self._finish_pending = True
                self._finish_lc = job.get("lc")
                self._stage_reclaim(None, job["finish_fault"])
                continue
            self._stage_complete(job)

    # -- executor-thread side (never touches loop-owned protocol state) --

    def _stage_dispatch(self, job: dict):
        """Double-buffered device dispatch: launch this batch's device
        kernel BEFORE the previous batch's device→host sync. Returns a
        state-machine handle, or None when the op cannot be dispatched
        ahead (non-transfer op, routing depends on the outstanding batch,
        host-only backend)."""
        h = job["msg"].header
        if h["operation"] != Operation.CREATE_TRANSFERS:
            return None
        events = np.frombuffer(job["msg"].body, dtype=types.TRANSFER_DTYPE)
        return self.state_machine.create_transfers_dispatch(
            events, int(h["timestamp"])
        )

    def _stage_process(self, job: dict):
        """One stage step (executor thread): dispatch this op's device
        work into the cross-batch window, settle the oldest batches once
        the window is at depth (sync, store, reply, compaction beat —
        strictly in op order), and run non-dispatchable ops in full after
        the whole window drains. Returns (publish, leftovers, ok) for the
        executor; ok=False parks the stage on a GridReadFault until the
        loop repairs and resets."""
        handle = None
        if self.commit_depth > 1:
            try:
                handle = self._stage_dispatch(job)
            except GridReadFault:
                # Dispatch is read-only: fall through to the full path,
                # which re-hits the fault at this op's proper turn.
                handle = None
        if handle is not None:
            # Split-phase device path: the op's execution begins at
            # dispatch — the settle stamp must not overwrite it, so the
            # commit-queue wait excludes device time (device time itself
            # is the device-step profiler's dispatch→finish row).
            tracer.op_stamp_first(job.get("lc"), tracer.OP_EXEC_START)
            job["_handle"] = handle
            self._stage_window.append(job)
            self._stage_note_inflight(len(self._stage_window))
            while len(self._stage_window) >= self.commit_depth:
                head = self._stage_window.popleft()
                publish, ok = self._stage_settle(head, self._stage_exec_held)
                if not ok:
                    return publish, self._stage_window_reclaim(), False
            return None, [], True
        # Non-dispatchable op (routing depends on in-flight batches, a
        # non-transfer op, host-only backend) or depth 1: it executes at
        # its own turn, after every dispatched batch ahead of it settles
        # — the id-overlap fence lands here as a window stall. The
        # sample counts the held batches PLUS this op: they are all
        # genuinely in flight until the window drains.
        self._stage_note_inflight(len(self._stage_window) + 1)
        publish, ok = self._stage_settle_window()
        if not ok:
            return publish, self._stage_window_reclaim() + [job], False
        publish, ok = self._stage_settle(job, self._stage_exec_full)
        return publish, [], ok

    def _stage_note_inflight(self, depth: int) -> None:
        """Occupancy sample, once per processed batch: how many batches
        are in flight through the commit window at its dispatch (1 on the
        serial/full path — the batch itself). Gauge for live scrapes,
        histogram (raw depth units) for the per-depth distribution and
        the benchmark's commit_inflight_mean."""
        if depth > self.stage_inflight_max:
            self.stage_inflight_max = depth
        if tracer.enabled():
            tracer.gauge("pipeline.commit.inflight", depth)
            tracer.observe("pipeline.commit.inflight_depth", depth)
            # Exact per-depth histogram (bounded: depth ≤ pipeline_max).
            tracer.count(f"pipeline.commit.inflight.d{depth}")
            # Re-asserted per batch so the configured depth survives a
            # registry reset (profile windows reset mid-process).
            tracer.gauge("pipeline.commit.depth_config", self.commit_depth)

    def _stage_settle_window(self):
        """Settle every window batch, oldest first. (publish, ok):
        ok=False left the remaining window for _stage_window_reclaim."""
        while self._stage_window:
            head = self._stage_window.popleft()
            publish, ok = self._stage_settle(head, self._stage_exec_held)
            if not ok:
                return publish, False
        return None, True

    def _stage_window_reclaim(self) -> List[dict]:
        """A fault parked the stage mid-window: abandon every dispatched-
        but-unfinished handle (one state-token rollback to the oldest
        live base — sm.create_transfers_abandon_all) and hand the jobs
        back, in op order, as executor leftovers for the loop's reclaim."""
        if not self._stage_window:
            return []
        jobs = list(self._stage_window)
        self._stage_window.clear()
        for j in jobs:
            j.pop("_handle", None)
        self.state_machine.create_transfers_abandon_all()
        return jobs

    def _stage_flush(self):
        """Queue ran dry: settle the whole dispatch window."""
        publish, ok = self._stage_settle_window()
        if not ok:
            return publish, self._stage_window_reclaim(), False
        return None, [], True

    def _stage_exec_full(self, job: dict) -> None:
        job["spec"] = self._execute(job["msg"], build_reply=False)

    def _stage_exec_held(self, job: dict) -> None:
        """Settle a dispatched op: device sync + store + reply spec, in
        the identical per-op order as the serial path."""
        msg = job["msg"]
        h = msg.header
        if self.aof is not None:
            self.aof.append(msg, self.primary_index(h["view"]), self.replica)
        sm = self.state_machine
        tracer.count("vsr.commits")
        with tracer.span("replica.execute"):
            results = sm.create_transfers_finish(job.pop("_handle")).tobytes()
            sm.prepare_timestamp = max(sm.prepare_timestamp, int(h["timestamp"]))
            job["spec"] = self._execute_tail(msg, results, build_reply=False)

    def _stage_settle(self, job: dict, run_exec) -> tuple:
        """Execute one op and publish its completion EARLY — the reply is
        built (through the preallocated scratch) and posted BEFORE the
        op's deferred store/compaction beat, mirroring the serial path's
        reply-first design — then run _finish_commit. Checkpoint-boundary
        ops publish only after their finish, so the loop's checkpoint
        always sees a quiescent state machine. Returns (publish, ok)."""
        boundary = job["op"] % self.config.checkpoint_interval == 0
        lc = job.get("lc")
        tracer.op_stamp_first(lc, tracer.OP_EXEC_START)
        try:
            run_exec(job)
            job["committed"] = True
        except GridReadFault as fault:
            job["fault"] = fault
            return job, False  # execute-phase fault: not committed
        tracer.op_stamp(lc, tracer.OP_EXEC_END)
        self._stage_emit(job)
        if not boundary:
            self.executor.complete(job)
        try:
            self._finish_commit(lc)
        except GridReadFault as fault:
            if boundary:
                job["fault"] = fault
                return job, False  # completion carries the finish fault
            # Completion already out: publish a finish-fault marker.
            return {"op": job["op"], "finish_fault": fault, "lc": lc}, False
        if boundary:
            self.executor.complete(job)
        return None, True

    def _stage_emit(self, job: dict) -> None:
        """Build the op's reply through the preallocated scratch builder
        and install it in the (replicated) client-session cache."""
        spec = job.get("spec")
        if spec is None:
            return
        with tracer.span("stage.reply"):
            reply = self._reply_builder.build_one(spec)
        job["reply"] = reply
        sess = self.clients.get(spec["client"])
        if sess is not None and sess.request == spec["request"]:
            sess.reply = reply

    # -- loop side: completion application -------------------------------

    def _stage_complete(self, job: dict) -> None:
        if not self._staged or self._staged[0] is not job:
            return  # stale completion from a reset stage
        self._staged.pop(0)
        op = job["op"]
        fault = job.get("fault")
        if fault is not None and not job.get("committed"):
            # Execute-phase fault: the op did NOT commit; requeue it (and
            # everything staged behind it) and repair the block.
            self._stage_reclaim(job, fault)
            return
        self.commit_min = op  # tidy: monotonic=commit_min — staged completions apply in submission (op) order
        self._drop_target(op)
        spec = job.get("spec")
        reply = job.get("reply")
        lc = job.get("lc")
        if job.get("entry") is not None and reply is not None:
            # Reply as soon as the completion lands — asyncio pushes it to
            # the socket while the executor already works on later ops.
            tracer.count("vsr.replies")
            self.bus.send_to_client(spec["client"], reply)
            tracer.op_stamp(lc, tracer.OP_REPLY)
        tracer.op_finish(lc)
        if fault is not None:
            # Finish-phase fault: committed, but the op's deferred
            # store/beat must complete after repair BEFORE any further op.
            self._finish_pending = True
            self._finish_lc = lc
            self._stage_reclaim(None, fault)
            return
        if not self._checkpoint_guarded():
            return
        self._commit_journal(self.commit_max)

    def _stage_reclaim(self, faulted_job: Optional[dict], fault: GridReadFault) -> None:
        """A fault parked the stage: reclaim every unexecuted job, put
        pipeline-origin entries back at the pipeline head (their replies
        must still be delivered on retry), and start the grid repair —
        the journal re-derives journal-origin ops after repair."""
        pending = self._staged
        self._staged = []
        if self.executor is not None:
            self.executor.reset()
        jobs = ([faulted_job] if faulted_job is not None else []) + pending
        for j in jobs:
            # The retry re-stamps execution (op_stamp_first): stale
            # stamps from the faulted attempt must not survive, or
            # service.execute would absorb the whole repair window.
            tracer.op_clear(
                j.get("lc"), tracer.OP_COMMIT_SUBMIT,
                tracer.OP_EXEC_START, tracer.OP_EXEC_END,
            )
        entries = [j["entry"] for j in jobs if j.get("entry") is not None]
        for e in reversed(entries):
            self.pipeline.insert(0, e)
        self._begin_grid_repair(fault)

    # --- repair ---------------------------------------------------------

    def _repair_peer(self) -> int:
        peer = self.primary_index(self.view)
        if peer == self.replica:
            peer = (self.replica + 1) % self.replica_count
        return peer

    def _repair_gaps(self, target: Optional[int] = None) -> None:
        if self.tick_count - self.last_repair_tick < REPAIR_TIMEOUT and target is None:
            return
        self.last_repair_tick = self.tick_count
        # Weak (HEADERS-derived, non-quorum-backed) targets whose content
        # never arrived may be pinning an op to a stale header from a lying
        # or lagging peer — age them out so repair can re-learn the op.
        expired = [
            op for op, t0 in self.repair_target_weak.items()
            if self.tick_count - t0 > 4 * REPAIR_TIMEOUT
        ]
        for op in expired:
            self._drop_target(op)
        peer = self._repair_peer()
        limit = target if target is not None else self.commit_max
        # Ops needing a prepare: journal holes up to the commit target,
        # recovery-classified faulty slots (torn bodies), and view-change
        # repair targets whose content hasn't arrived yet. Presence checks
        # go through the header map — no disk reads in this scan.
        wants: set[int] = set()
        for want in range(self.commit_min + 1, limit + 1):
            if not self._journal_has_target(want):
                wants.add(want)
        for slot in self.journal.faulty:
            h = self.journal.headers.get(slot)
            if h is not None and h["op"] > self.commit_min:
                wants.add(h["op"])
        for op in self.repair_target:
            if op > self.commit_min and not self._journal_has_target(op):
                wants.add(op)
        if wants:
            tracer.count("mark.wal_repair_request")
        for want in sorted(wants)[:8]:
            rp = hdr.make(
                Command.REQUEST_PREPARE, self.cluster,
                view=self.view, op=want, replica=self.replica,
            )
            self.bus.send_to_replica(peer, Message(rp).seal())
        # Holes beyond the commit window whose headers we've never seen:
        # fetch the headers first (reference request_headers,
        # replica.zig:2131) so their content becomes a repair target.
        if self.op > limit and any(
            not self._journal_has_op(o) for o in range(limit + 1, self.op + 1)
        ):
            rh = hdr.make(
                Command.REQUEST_HEADERS, self.cluster,
                view=self.view, replica=self.replica,
                commit=limit + 1, op=self.op,
            )
            self.bus.send_to_replica(peer, Message(rh).seal())

    def _drop_target(self, op: int) -> None:
        self.repair_target.pop(op, None)
        self.repair_target_weak.pop(op, None)

    def _set_targets(self, targets: Dict[int, Header]) -> None:
        """Install quorum-backed winning-log targets wholesale (view change).

        Each target is also written into the journal header ring (reference
        replace_header): a replica that crashes with a pending target must
        not, on restart, replay the stale divergent body at that op as
        committed — recovery re-classifies the slot faulty and repair
        re-fetches the winning content.
        """
        self.repair_target = dict(targets)
        self.repair_target_weak = {}
        for op in sorted(targets):
            if self.journal.can_write(op):
                self.journal.install_header(targets[op], sync=False)
        if targets:
            self.storage.sync()

    def _journal_has_target(self, op: int) -> bool:
        """Is the journal's content at op trustworthy: present, not torn,
        and (when a winning-log target exists) matching it?"""
        if not self._journal_has_op(op):
            return False
        target = self.repair_target.get(op)
        if target is None:
            return True
        return self._journal_matches(op, target)

    def on_request_headers(self, msg: Message) -> None:
        """Serve journal headers in [commit, op] (reference on_request_headers,
        replica.zig:2131)."""
        op_min = msg.header["commit"]
        op_max = min(msg.header["op"], op_min + 64)
        out = []
        for op in range(op_min, op_max + 1):
            # Only advertise content we can actually serve: not torn
            # (faulty) and not itself pending winning-log repair.
            if self._journal_has_target(op):
                out.append(self.journal.headers[self.journal.slot_for_op(op)])
        if not out:
            return
        resp = hdr.make(
            Command.HEADERS, self.cluster, view=self.view, replica=self.replica,
        )
        body = b"".join(h.to_bytes() for h in out)
        self.bus.send_to_replica(msg.header["replica"], Message(resp, body).seal())

    def on_headers(self, msg: Message) -> None:
        """Fill journal HOLES from received headers and fetch their prepares
        (reference on_headers → repair). Unlike SV/DVC bodies, HEADERS are
        not quorum-backed: a stale or delayed response must never override
        existing content or an installed winning-log target, so only ops we
        hold nothing for are accepted, and only in the current view.
        """
        if self.status != STATUS_NORMAL or msg.header["view"] != self.view:
            return
        if self.is_primary:
            return  # the primary's log/targets are already authoritative
        sender = msg.header["replica"]
        for h in _parse_headers(msg.body):
            op = h["op"]
            if op <= self.commit_min or op > self.op:
                continue
            if self._journal_has_op(op) or op in self.repair_target:
                continue
            # A faulty slot whose ring header already names this op holds a
            # durable quorum-backed target (install_header, possibly from
            # before a restart) — a weak HEADERS target must not shadow it.
            slot = self.journal.slot_for_op(op)
            if slot in self.journal.faulty:
                ring = self.journal.headers.get(slot)
                if ring is not None and ring["op"] == op:
                    continue
            self.repair_target[op] = h
            self.repair_target_weak[op] = self.tick_count
            rp = hdr.make(
                Command.REQUEST_PREPARE, self.cluster,
                view=self.view, op=op, replica=self.replica,
            )
            self.bus.send_to_replica(sender, Message(rp).seal())

    def on_request_prepare(self, msg: Message) -> None:
        op = msg.header["op"]
        # Never serve content that is itself pending winning-log repair —
        # propagating a stale prepare could commit divergent state remotely.
        m = self.journal.read_prepare(op) if self._journal_has_target(op) else None
        if m is not None:
            self.bus.send_to_replica(msg.header["replica"], m)
            return
        # The requested op predates our checkpoint (WAL ring wrapped): the
        # requester is too far behind for WAL repair and must state-sync
        # (reference docs/internals/sync.md; replica.zig:7765+). Start the
        # chunked transfer: the first chunk announces (count, size, whole-
        # blob checksum); the requester pulls the rest.
        st = self.superblock.state
        if op <= st.op_checkpoint and st.op_checkpoint > 0:
            self._send_sync_chunk(msg.header["replica"], 0)

    # --- state sync (chunked; reference sync.zig + docs/internals/sync.md) -

    SYNC_CHUNKS_IN_FLIGHT = 4  # request pipelining for large snapshots

    def _sync_blob(self) -> Optional[tuple]:
        """(checkpoint_op, blob, whole-blob checksum), cached per checkpoint."""
        st = self.superblock.state
        if st.op_checkpoint == 0 or st.trailer_block == NO_TRAILER:
            return None
        cached = self._sync_serve_cache
        if cached is not None and cached[0] == st.op_checkpoint:
            return cached
        self._quiesce_commit_stage()  # trailer blocks are grid reads
        if not self._quiesce_store_stage():
            return None  # store stage parked on a fault: grid incomplete
        try:
            blob = self._trailer_read(st.trailer_block)
        except IOError:
            return None  # local trailer corrupt — cannot serve sync
        # Block-level sync: the blob itself is O(accounts + tables); the
        # peer fetches whichever referenced grid blocks it is missing via
        # REQUEST_BLOCKS (never the whole history).
        self._sync_serve_cache = (st.op_checkpoint, blob, hdr.checksum(blob))
        return self._sync_serve_cache

    def _send_sync_chunk(self, peer: int, index: int) -> None:
        entry = self._sync_blob()
        if entry is None:
            return
        cp_op, blob, ident = entry
        chunk_size = self.config.message_size_max - hdr.HEADER_SIZE
        count = max(1, -(-len(blob) // chunk_size))
        if index >= count:
            return
        sc = hdr.make(
            Command.SYNC_CHECKPOINT, self.cluster,
            view=self.view, replica=self.replica,
            op=index, commit=count, timestamp=len(blob),
            checkpoint_op=cp_op, parent=ident,
        )
        chunk = blob[index * chunk_size : (index + 1) * chunk_size]
        self.bus.send_to_replica(peer, Message(sc, chunk).seal())

    def on_request_sync_checkpoint(self, msg: Message) -> None:
        self._send_sync_chunk(msg.header["replica"], msg.header["op"])

    def _request_sync_chunks(self, retry: bool = False) -> None:
        """Top up the request window to SYNC_CHUNKS_IN_FLIGHT outstanding
        chunks; `retry` forgets in-flight requests that never landed (lost
        or corrupt-dropped) so the timeout path re-issues them."""
        s = self._sync
        assert s is not None
        if retry:
            s["requested"] &= set(s["chunks"])
        outstanding = len(s["requested"] - set(s["chunks"]))
        budget = self.SYNC_CHUNKS_IN_FLIGHT - outstanding
        if budget <= 0:
            return
        to_request = [
            i for i in range(s["count"])
            if i not in s["chunks"] and i not in s["requested"]
        ][:budget]
        for index in to_request:
            s["requested"].add(index)
            rq = hdr.make(
                Command.REQUEST_SYNC_CHECKPOINT, self.cluster,
                view=self.view, replica=self.replica,
                op=index, checkpoint_op=s["checkpoint_op"],
            )
            self.bus.send_to_replica(s["peer"], Message(rq).seal())

    def _sync_tick(self) -> None:
        """Resume a stalled chunked sync (lost or corrupt chunks are simply
        never delivered — Message.verify drops them — so re-request), and
        a stalled block sync (lost BLOCKs re-requested; repeated stalls
        escalate to a fresh trailer request — the serving side may have
        checkpointed past the content we are fetching)."""
        bs = self._block_sync
        if bs is not None and self.tick_count - bs["last_tick"] >= 2 * REPAIR_TIMEOUT:
            bs["last_tick"] = self.tick_count
            bs["stalls"] = bs.get("stalls", 0) + 1
            if self.replica_count > 1:
                # Rotate the serving peer (it may be down or lagging).
                nxt = (bs.get("peer", self.replica) + 1) % self.replica_count
                bs["peer"] = nxt if nxt != self.replica else (
                    (nxt + 1) % self.replica_count
                )
            if bs["stalls"] % 4 == 0 and self.replica_count > 1:
                # Content may be gone on the peers (blocks reused by newer
                # checkpoints): restart sync at whatever checkpoint the
                # cluster now serves. sync_pending stays set until SOME
                # sync completes.
                peer = (self.replica + bs["stalls"] // 4) % self.replica_count
                if peer != self.replica:
                    rq = hdr.make(
                        Command.REQUEST_PREPARE, self.cluster,
                        view=self.view, op=self.commit_min + 1,
                        replica=self.replica,
                    )
                    self.bus.send_to_replica(peer, Message(rq).seal())
            self._request_missing_blocks(retry=True)
        s = self._sync
        if s is None:
            return
        if s["checkpoint_op"] <= max(self.commit_min, self.superblock.state.op_checkpoint):
            self._sync = None  # caught up via WAL repair meanwhile
            return
        if self.tick_count - s["last_tick"] >= 2 * REPAIR_TIMEOUT:
            s["last_tick"] = self.tick_count
            self._request_sync_chunks(retry=True)

    def on_sync_checkpoint(self, msg: Message) -> None:
        """Accumulate chunked snapshot state; install when complete."""
        h = msg.header
        sync_op = h["checkpoint_op"]
        if sync_op <= self.commit_min or sync_op <= self.superblock.state.op_checkpoint:
            return
        ident = h["parent"]
        s = self._sync
        if s is not None and (s["checkpoint_op"], s["ident"]) != (sync_op, ident):
            # Competing transfer: prefer the newer checkpoint.
            if sync_op < s["checkpoint_op"]:
                return
            s = None
        if s is None:
            tracer.count("recovery.sync_begin")
            s = self._sync = {
                "checkpoint_op": sync_op, "ident": ident,
                "count": h["commit"], "total": h["timestamp"],
                "chunks": {}, "requested": set(),
                "peer": h["replica"], "last_tick": self.tick_count,
            }
        index = h["op"]
        if index < s["count"] and index not in s["chunks"]:
            s["chunks"][index] = msg.body
            # Only progress refreshes the stall timer: duplicate announces
            # (the repair loop re-sends chunk 0 each repair tick) must not
            # keep postponing the lost-chunk retry forever.
            s["last_tick"] = self.tick_count
        s["peer"] = h["replica"]
        if len(s["chunks"]) < s["count"]:
            self._request_sync_chunks()
            return
        blob = b"".join(s["chunks"][i] for i in range(s["count"]))
        self._sync = None
        if len(blob) != s["total"] or hdr.checksum(blob) != s["ident"]:
            return  # torn/forged assembly — a retry will start fresh
        self._install_sync_checkpoint(sync_op, blob)

    def _install_sync_checkpoint(self, sync_op: int, blob: bytes) -> None:
        """Install a peer's checkpoint trailer, persist it as our own
        durable checkpoint (sync_pending set), then fetch exactly the
        referenced grid blocks our grid is missing (block-level sync —
        reference replica.zig:2289,2413, docs/internals/sync.md). Traffic
        is proportional to the state DELTA: blocks whose local checksum
        already matches the blob's block_cks list are never transferred.

        Crash-consistency: before the superblock flip, only currently-free
        blocks are written (the trailer), so a crash recovers the old
        checkpoint. After the flip (sync_pending durable), missing-block
        writes may overwrite stale old-checkpoint blocks — a crash then
        resumes block sync at open() from the durable trailer.
        """
        # Parse-validate BEFORE any destructive step: a checksum-consistent
        # but structurally malformed blob (corrupt store entry or forged
        # ident) must neither crash the replica loop nor destroy state.
        if not snapshot.validate(blob):
            return
        # The install replaces the state machine wholesale: the executor
        # must not be mid-op against the old one.
        self._quiesce_commit_stage()
        # Draining the stage applies queued completions, so commit_min
        # (and, through a checkpoint landing inside the drain, even the
        # durable op_checkpoint) may have advanced PAST this blob while
        # we quiesced: the arrival-time freshness check in
        # on_sync_checkpoint no longer holds. Installing now would
        # regress commit_min/checksum_floor and re-point the superblock
        # at an older checkpoint — abandon instead, exactly like the
        # caught-up-via-WAL-repair path in _tick_sync.
        if sync_op <= max(self.commit_min, self.superblock.state.op_checkpoint):
            tracer.count("recovery.sync_stale_abandon")
            return
        if self.store_executor is not None:
            # Queued store jobs write state the installed checkpoint
            # already covers wholesale: discard them (and any parked
            # fault) — the new trees restore from the blob.
            self.store_executor.reset()
            self._store_resume = None
        # A state sync supersedes any in-flight normal-operation grid
        # repair: the installed checkpoint replaces the state the faulted
        # op would have produced, so the repair gates (and any half-done
        # beat resume point) are void.
        self._grid_repair = None
        self._finish_pending = False
        self._finish_lc = None
        self.state_machine._beat_stage = 0
        from tigerbeetle_tpu_torch.io.grid import FreeSet

        grid = self.state_machine.grid
        old_sm, old_clients, old_free = self.state_machine, self.clients, grid.free_set
        old_trailer = list(self._trailer_blocks)
        old_block_cks = dict(grid.block_cks)
        install_free = FreeSet(grid.block_count)
        install_free.free = old_free.free.copy()  # staged frees stay allocated
        grid.free_set = install_free
        self.state_machine = StateMachine(
            self.config, device=self.device, grid=grid,
            device_query_index=self.device_query_index,
        )
        if self.store_executor is not None:
            self.state_machine.attach_store_stage(self.store_executor)
        # The client table is replicated state — it must exactly match the
        # installed checkpoint, so sessions from before the sync are dropped.
        self.clients = {}
        wanted = snapshot.block_checksums(blob)
        try:
            tracer.count("mark.state_sync_install")
            # RAM state + manifests only; the free-set restore inside is
            # overwritten below (install_free governs until the flip), and
            # the Bloom rebuild waits for the log blocks to arrive.
            snapshot.install(
                self, blob, rebuild_bloom=False, block_cks_map=wanted
            )
        except Exception:
            # Residual failure: every block the old state references is
            # intact — roll back wholesale (including the checksum map,
            # which install() already overlaid with the peer's entries).
            grid.free_set = old_free
            grid.block_cks = old_block_cks
            grid.drop_cache()
            self.state_machine.release()
            self.state_machine, self.clients = old_sm, old_clients
            self._trailer_blocks = old_trailer
            return
        # The installed machine replaces the old one for good: let go of
        # the old one's device state (balance tables, lazy query runs, a
        # pending compaction fold) and its memory-ledger bytes.
        old_sm.release()
        # install() rewound the free set (in place) to the blob's
        # references-exact bits; reinstate the INSTALL bits until the
        # superblock flip — the trailer must not land on blocks the
        # rollback state (or our previous trailer) still needs. Blocks the
        # INSTALLED checkpoint references are additionally excluded: block
        # sync will write the peer's content at exactly those indices, so
        # the trailer must not occupy them either.
        install_free.free = old_free.free.copy()
        install_free._staged = []
        if wanted:
            install_free.free[np.array(sorted(wanted), dtype=np.int64)] = False
        self.commit_min = sync_op
        self.checksum_floor = sync_op  # tidy: monotonic=checksum_floor — covered by the post-quiesce sync_op freshness re-check (checksum_floor == op_checkpoint <= commit_min < sync_op)
        self.op = max(self.op, sync_op)
        st = self.superblock.state
        st.op_checkpoint = sync_op
        st.commit_min = sync_op
        st.commit_max = max(st.commit_max, sync_op)
        st.trailer_block = self._trailer_write()
        st.sync_pending = 1
        self.storage.sync()
        self.superblock.checkpoint()
        # Flip durable: now adopt the references-exact free set (trailer
        # blocks re-marked — they are excluded from the encoding) and
        # start fetching the missing content blocks.
        fs = snapshot.free_set_bytes(self._trailer_read(st.trailer_block))
        assert fs is not None
        grid.free_set.restore(fs)
        self._mark_trailer_allocated()
        grid.drop_cache()
        self._sync_serve_cache = None
        self._begin_block_sync(wanted)

    # --- block-level sync (receiver) ------------------------------------

    BLOCKS_PER_REQUEST = 64
    BLOCK_REQUESTS_IN_FLIGHT = 4

    def _begin_block_sync(self, wanted: Dict[int, int]) -> None:
        """Verify the local grid against the checkpoint's (index,
        checksum) list; fetch only mismatches. Commits stay gated until
        every referenced block is present."""
        grid = self.state_machine.grid
        missing = {
            b: c for b, c in wanted.items() if grid.local_checksum(b) != c
        }
        tracer.count("mark.block_sync_begin")
        self._block_sync = {
            "missing": missing, "requested": set(),
            "last_tick": self.tick_count, "fetched": 0,
        }
        # Observability (tests + ops): how much of the referenced set the
        # local grid already held — the delta-proportionality of sync.
        self.block_sync_stats = {"wanted": len(wanted), "missing": len(missing)}
        log.info(
            "replica %d: block sync: %d/%d blocks missing",
            self.replica, len(missing), len(wanted),
        )
        if not missing:
            self._finish_block_sync()
            return
        self._request_missing_blocks()

    def _request_missing_blocks(self, retry: bool = False) -> None:
        s = self._block_sync
        if s is None or not s["missing"]:
            return
        if retry:
            # Everything outstanding is presumed lost (or the peer lacked
            # it): forget the in-flight set so the blocks are re-requested
            # (from the rotated peer).
            s["requested"].clear()
        window = self.BLOCK_REQUESTS_IN_FLIGHT * self.BLOCKS_PER_REQUEST
        outstanding = len(s["requested"])
        # Low-water top-up: re-requesting on every BLOCK arrival would send
        # one single-index request per remaining block; refill in full
        # batches once half the window has drained.
        if outstanding > window // 2:
            return
        to_request = [
            b for b in sorted(s["missing"]) if b not in s["requested"]
        ][: window - outstanding]
        if not to_request:
            return
        s["requested"].update(to_request)
        peer = s.get("peer")
        if peer is None or peer == self.replica:
            peer = (self.replica + 1) % self.replica_count
            s["peer"] = peer
        if peer == self.replica:
            return  # single-replica cluster: nothing to fetch from
        for i in range(0, len(to_request), self.BLOCKS_PER_REQUEST):
            chunk = to_request[i : i + self.BLOCKS_PER_REQUEST]
            body = np.array(chunk, dtype=np.uint32).tobytes()
            rq = hdr.make(
                Command.REQUEST_BLOCKS, self.cluster,
                view=self.view, replica=self.replica,
            )
            self.bus.send_to_replica(peer, Message(rq, body).seal())

    def on_request_blocks(self, msg: Message) -> None:
        """Serve grid blocks by index (reference on_request_blocks,
        replica.zig:2289). Content identity is the receiver's problem: it
        verifies each payload against its wanted checksum, so serving a
        since-reused block is harmless (re-requested elsewhere)."""
        peer = msg.header["replica"]
        # Serving reads the grid the executors may be compacting into —
        # settle both stages first (cheap when they are empty). A parked
        # store stage means our own grid is mid-repair: do not serve, the
        # peer re-requests elsewhere.
        self._quiesce_commit_stage()
        if not self._quiesce_store_stage():
            return
        indices = np.frombuffer(msg.body, dtype=np.uint32)
        grid = self.state_machine.grid
        for b in indices[: self.BLOCKS_PER_REQUEST]:
            try:
                payload, btype = grid.read_block_typed(int(b))
            except (IOError, AssertionError):
                continue  # torn/corrupt/out-of-range: peer re-requests
            bh = hdr.make(
                Command.BLOCK, self.cluster,
                view=self.view, replica=self.replica,
                op=int(b), request=btype,
            )
            self.bus.send_to_replica(peer, Message(bh, payload).seal())

    def on_block(self, msg: Message) -> None:
        s = self._block_sync
        if s is None:
            if self._grid_repair is not None:
                self._on_repair_block(msg)
            return
        h = msg.header
        index = h["op"]
        want = s["missing"].get(index)
        if want is None:
            return
        if hdr.checksum(msg.body) != want:
            # Stale content (the peer reused the block since the trailer we
            # installed): drop; the stall path re-requests and eventually
            # restarts sync at a newer checkpoint.
            s["requested"].discard(index)
            return
        self.state_machine.grid.write_block_at(index, msg.body, h["request"])
        del s["missing"][index]
        s["requested"].discard(index)
        s["fetched"] += 1
        s["last_tick"] = self.tick_count
        if s["missing"]:
            self._request_missing_blocks()
        else:
            self._finish_block_sync()

    # --- normal-operation grid repair -----------------------------------
    # (reference grid_blocks_missing.zig:513 + replica.zig:2289,2413:
    # block repair is an always-on protocol — a single corrupt block is
    # fetched from a peer and rewritten in place, no state sync.)

    GRID_REPAIR_RETRY_TICKS = 50

    def _begin_grid_repair(self, fault: GridReadFault) -> None:
        if self.replica_count == 1 or fault.expected is None:
            # No peer to repair from, or the block's identity is unknown
            # (not in the RAM map nor any loaded trailer): fail-stop
            # loudly — restart-from-checkpoint or operator intervention.
            raise fault
        if self._grid_repair is None:
            self._grid_repair = {
                "missing": {}, "last_tick": self.tick_count, "peer": None,
            }
        self._grid_repair["missing"][fault.index] = fault.expected
        tracer.count("mark.grid_repair_begin")
        log.warning(
            "replica %d: grid block %d corrupt in normal operation — "
            "repairing from a peer", self.replica, fault.index,
        )
        self._send_grid_repair_requests()

    def _send_grid_repair_requests(self, rotate: bool = False) -> None:
        s = self._grid_repair
        if s is None or not s["missing"]:
            return
        peer = s.get("peer")
        if peer is None:
            peer = self._repair_peer()
        elif rotate:
            peer = (peer + 1) % self.replica_count
            if peer == self.replica:
                peer = (peer + 1) % self.replica_count
        s["peer"] = peer
        s["last_tick"] = self.tick_count
        wanted = sorted(s["missing"])
        for i in range(0, len(wanted), self.BLOCKS_PER_REQUEST):
            body = np.array(
                wanted[i : i + self.BLOCKS_PER_REQUEST], dtype=np.uint32
            ).tobytes()
            rq = hdr.make(
                Command.REQUEST_BLOCKS, self.cluster,
                view=self.view, replica=self.replica,
            )
            self.bus.send_to_replica(peer, Message(rq, body).seal())

    def _grid_repair_tick(self) -> None:
        s = self._grid_repair
        if s is None:
            return
        if self.tick_count - s["last_tick"] >= self.GRID_REPAIR_RETRY_TICKS:
            s["stalls"] = s.get("stalls", 0) + 1
            self._send_grid_repair_requests(rotate=True)
            if s["stalls"] % 4 == 0:
                # The wanted block version may be GONE cluster-wide: once
                # every peer checkpointed past our gated commit point, the
                # block's index can be reused for new content and every
                # served BLOCK fails our checksum check. Probe with
                # REQUEST_PREPARE for our next commit: a peer whose WAL
                # still covers it serves the prepare (harmless), one that
                # checkpointed past it starts the chunked state sync that
                # replaces our whole state (clearing the repair gates in
                # _install_sync_checkpoint). Commit gates STAY UP until
                # then — resuming without the missed store/beat would
                # diverge the deterministic layout.
                peer = s.get("peer")
                if peer is not None and peer != self.replica:
                    rq = hdr.make(
                        Command.REQUEST_PREPARE, self.cluster,
                        view=self.view, op=self.commit_min + 1,
                        replica=self.replica,
                    )
                    self.bus.send_to_replica(peer, Message(rq).seal())

    def _on_repair_block(self, msg: Message) -> None:
        s = self._grid_repair
        h = msg.header
        index = int(h["op"])
        want = s["missing"].get(index)
        if want is None or hdr.checksum(msg.body) != want:
            return  # not ours / stale content: the retry tick re-requests
        grid = self.state_machine.grid
        grid.write_block_at(index, msg.body, int(h["request"]))
        del s["missing"][index]
        tracer.count("mark.grid_repair_block")
        if s["missing"]:
            return
        self._grid_repair = None
        self.storage.sync()  # the repaired block must survive a restart
        log.info("replica %d: grid repair complete", self.replica)
        tracer.count("mark.grid_repair_done")
        self.on_event("grid_repair", self)
        if self._store_resume is not None:
            # The faulted async store job resumes on the stage thread at
            # exactly the beat stage it parked in (sm._beat_stage); a
            # second fault re-parks and the notify path re-gates.
            job, self._store_resume = self._store_resume, None
            self._finish_pending = False
            self.store_executor.resume(job)
        elif self._finish_pending:
            self._finish_pending = False
            lc, self._finish_lc = self._finish_lc, None
            try:
                self._finish_commit(lc)
            except GridReadFault as fault:
                self._finish_pending = True
                self._finish_lc = lc
                self._begin_grid_repair(fault)
                return
        # Retry (or perform) any due checkpoint — _maybe_checkpoint no-ops
        # away from interval boundaries, so one guarded call covers both
        # the faulted-checkpoint retry and the just-finished op's turn.
        self._checkpoint_pending = False
        if not self._checkpoint_guarded():
            return
        # Resume the gated commit stream. A primary with a requeued
        # pipeline head MUST resume through the pipeline (committing the
        # op via the journal path would discard its client reply and
        # leave the stale head wedging the pipeline forever).
        if self.is_primary and self.pipeline:
            self._check_pipeline_quorum()
        else:
            self._commit_journal(self.commit_max)

    def _finish_block_sync(self) -> None:
        """Every referenced block present: make them durable, clear the
        sync_pending flag, rebuild RAM-only derived state, resume."""
        fetched = self._block_sync["fetched"] if self._block_sync else 0
        self._block_sync = None
        self.storage.sync()
        st = self.superblock.state
        if st.sync_pending:
            st.sync_pending = 0
            self.superblock.checkpoint()
        snapshot.rebuild_transfer_bloom(self.state_machine)
        tracer.count("mark.block_sync_done")
        tracer.count("recovery.sync_complete")
        log.info(
            "replica %d: block sync complete (%d blocks fetched)",
            self.replica, fetched,
        )
        self.on_event("sync", self)
        self._commit_journal(self.commit_max)

    # --- view change ----------------------------------------------------

    def _vote_view_change(self, new_view: int) -> None:
        """Send START_VIEW_CHANGE for new_view WITHOUT leaving the current
        status. The status transition is gated on an SVC quorum (reference
        replica.zig on_start_view_change quorum): an isolated replica that
        transitioned unilaterally would stop accepting current-view
        heartbeats and its view would run away past the live cluster's,
        wedging it permanently (observed at VOPR seed 142)."""
        self.last_heartbeat_tick = self.tick_count
        if self.is_standby:
            # Standbys neither vote nor count toward view-change quorums;
            # they follow completed view changes via START_VIEW /
            # prepare-view catch-up.
            return
        svc = hdr.make(
            Command.START_VIEW_CHANGE, self.cluster,
            view=new_view, replica=self.replica, epoch=self.config_epoch,
        )
        m = Message(svc).seal()
        for r in range(self.replica_count):
            if r != self.replica:
                self.bus.send_to_replica(r, m)
        self.start_view_change_from.setdefault(new_view, set()).add(self.replica)
        self._maybe_enter_view_change(new_view)

    def _normal_timeout_view(self) -> int:
        """The view a backup in normal status votes for when the primary
        has gone quiet: view + 1, unless it has already voted for view + 1
        and other replicas have moved on to a higher ballot. Then it joins
        the highest such ballot. Without this, a backup that missed a
        view change its peers completed among themselves votes view + 1
        forever while they, stuck in view_change at view + 1, vote view +
        2: neither ballot reaches a quorum (VOPR seed 101). The quorum
        gate of _maybe_enter_view_change stays: the vote joins ballots
        other replicas actually cast, so an isolated replica's view
        cannot run away (the seed-142 rule)."""
        nxt = self.view + 1
        if self.replica not in self.start_view_change_from.get(nxt, ()):
            return nxt
        ahead = [
            v for v, voters in self.start_view_change_from.items()
            if v > nxt and voters - {self.replica}
        ]
        return max(ahead, default=nxt)

    def _maybe_enter_view_change(self, v: int) -> None:
        """Enter view_change status for view v once a full quorum of
        distinct replicas has ACTUALLY voted for it (our own vote counts
        only if we sent one — reference replica.zig:1712-1727). A single
        flaky replica's lone SVC must never pull a healthy cluster out of
        normal processing."""
        if v == self.view and self.status == STATUS_VIEW_CHANGE:
            self._maybe_send_do_view_change(v)
            return
        if v <= self.view:
            return
        if len(self.start_view_change_from.get(v, set())) >= self.quorum_view_change:
            self._start_view_change(v)

    def _start_view_change(self, new_view: int) -> None:
        """Enter view_change for new_view (SVC quorum observed, or a DVC/SV
        for the view proves one existed)."""
        assert new_view > self.view or self.status != STATUS_NORMAL
        # Leaving normal status: the commit stage must be empty — its ops
        # are committed and the DVC below advertises commit_min.
        self._quiesce_commit_stage()
        if self.status == STATUS_NORMAL:
            self.log_view = self.view  # tidy: monotonic=log_view — normal status already has log_view == view (freeze at view-change entry, not a bump)
        log.info("replica %d: view_change -> view %d", self.replica, new_view)
        tracer.count("mark.view_change_enter")
        # View-change episode t0: a mid-change view bump (flap, dueling
        # candidates) keeps the original stamp — the phases decompose the
        # whole client-visible blackout, not the last ballot.
        import time as _time

        if self._vc_t0 is None:
            self._vc_t0 = _time.perf_counter()  # tidy: allow=wall-clock — view-change observability only, never reaches replicated state
            self.view_change_stats = {}
        self._vc_dvc_t = None
        # Leaving normal status: close every partial peer window —
        # whatever per-peer stamps landed stay, nothing is fabricated.
        self.peer_stats.close_all()
        self.status = STATUS_VIEW_CHANGE
        self.view = max(self.view, new_view)
        tracer.gauge("vsr.view", self.view)
        tracer.gauge("vsr.is_primary", 0)
        self.last_heartbeat_tick = self.tick_count
        # The view promise must be durable BEFORE any DVC leaves this
        # replica (reference view_durable): a replica that votes, crashes,
        # and restarts with the older view could otherwise ack prepares in
        # a view it promised to abandon, breaking quorum intersection.
        self._persist_view()
        svc = hdr.make(
            Command.START_VIEW_CHANGE, self.cluster,
            view=new_view, replica=self.replica, epoch=self.config_epoch,
        )
        m = Message(svc).seal()
        for r in range(self.replica_count):
            if r != self.replica:
                self.bus.send_to_replica(r, m)
        self.start_view_change_from.setdefault(new_view, set()).add(self.replica)
        self._maybe_send_do_view_change(new_view)

    def on_start_view_change(self, msg: Message) -> None:
        v = msg.header["view"]
        if v < self.view:
            return
        if msg.header["epoch"] < self.slot_epoch.get(int(msg.header["replica"]), 0):
            return  # stale occupant of a reassigned slot: no view-change vote
        self.start_view_change_from.setdefault(v, set()).add(msg.header["replica"])
        self._maybe_enter_view_change(v)

    def _maybe_send_do_view_change(self, v: int) -> None:
        if self.status != STATUS_VIEW_CHANGE or v != self.view:
            return
        if len(self.start_view_change_from.get(v, set())) < self.quorum_view_change:
            return
        if self._dvc_sent_for_view >= v:
            return
        self._dvc_sent_for_view = v
        if self._vc_t0 is not None:
            # SVC-wait phase closes: quorum of start_view_change votes
            # observed, our DVC leaves for the candidate primary.
            import time as _time

            self._vc_dvc_t = _time.perf_counter()  # tidy: allow=wall-clock — view-change observability only, never reaches replicated state
            self.view_change_stats["svc_wait_s"] = round(
                self._vc_dvc_t - self._vc_t0, 6
            )
            tracer.gauge(
                "vsr.view_change.svc_wait_s",
                self.view_change_stats["svc_wait_s"],
            )
        # Advertise the WINNING log, not the raw journal: where a repair
        # target is pending the local journal content is stale, and a DVC
        # carrying it could win the candidate merge and resurrect divergent
        # content (the exact divergence view change exists to prevent).
        headers = self._sv_body_headers()
        dvc = hdr.make(
            Command.DO_VIEW_CHANGE, self.cluster,
            view=v, replica=self.replica, op=self.op,
            commit=self.commit_min, timestamp=self.log_view,
            epoch=self.config_epoch,
        )
        body = b"".join(h.to_bytes() for h in headers)
        m = Message(dvc, body).seal()
        primary = self.primary_index(v)
        if primary == self.replica:
            self.on_do_view_change(m)
        else:
            self.bus.send_to_replica(primary, m)

    # DVC/SV bodies carry this many trailing headers. Soundness bound:
    # divergent content can only exist in an UNCOMMITTED suffix, whose
    # length is capped by the prepare pipeline (pipeline_max = 8 in
    # flight, reference config.zig:133) — committed prefixes are unique by
    # quorum intersection, so ops below the window can be *missing* on a
    # lagging backup (repaired via the paged REQUEST_HEADERS walk,
    # tests/test_view_change.py deep-backlog scenario) but never wrong.
    # 32 = 4x pipeline_max margin.
    VIEW_HEADERS_WINDOW = 32

    def _sv_body_headers(self) -> List[Header]:
        """Headers describing the WINNING log for a START_VIEW body: where a
        repair target exists the local journal is stale, so the target
        header is authoritative; elsewhere the journal entry is."""
        out = []
        for op in range(max(1, self.op - self.VIEW_HEADERS_WINDOW), self.op + 1):
            target = self.repair_target.get(op)
            if target is not None:
                out.append(target)
                continue
            h = self.journal.headers.get(self.journal.slot_for_op(op))
            if h is not None and h["op"] == op:
                out.append(h)
        return out

    def on_do_view_change(self, msg: Message) -> None:
        v = msg.header["view"]
        if v < self.view or self.primary_index(v) != self.replica:
            return
        if msg.header["epoch"] < self.slot_epoch.get(int(msg.header["replica"]), 0):
            return  # stale occupant: its log must not win an election
        if v > self.view:
            self._start_view_change(v)
        self.do_view_change_from.setdefault(v, {})[msg.header["replica"]] = msg
        dvcs = self.do_view_change_from[v]
        if len(dvcs) < self.quorum_view_change:
            return
        if self.status != STATUS_VIEW_CHANGE or self.view != v:
            return

        # DVC-collect phase closes: a quorum of logs is in hand — from
        # here to serving is the new primary's replay/re-proposal work.
        import time as _time

        t_sv = _time.perf_counter()  # tidy: allow=wall-clock — view-change observability only, never reaches replicated state
        if self._vc_dvc_t is not None:
            self.view_change_stats["dvc_collect_s"] = round(
                t_sv - self._vc_dvc_t, 6
            )
            tracer.gauge(
                "vsr.view_change.dvc_collect_s",
                self.view_change_stats["dvc_collect_s"],
            )

        # Reference DVCQuorum: the winning log is defined by the DVCs with
        # the highest log_view (carried in `timestamp`); its length is their
        # max op. Everything above that op — including this replica's own
        # surviving journal tail from an older log_view — is uncommitted by
        # definition and must be truncated, or a stale divergent entry could
        # be re-proposed and commit different content than a later view did.
        log_view_max = max(m.header["timestamp"] for m in dvcs.values())
        candidates = [
            m for m in dvcs.values() if m.header["timestamp"] == log_view_max
        ]
        new_op = max(m.header["op"] for m in candidates)
        new_commit = max(m.header["commit"] for m in dvcs.values())

        # Merge the candidates' header windows. Within one log_view every op
        # slot was assigned exactly once by that view's primary, so shared
        # ops normally agree on content. A conflict can still appear if a
        # candidate advertises content it has not yet repaired (stale body
        # from an older prepare view): resolve deterministically — the
        # header whose prepare carries the higher view is the re-proposal
        # the winning log kept; tie-break on checksum_body so every replica
        # computes the same merge regardless of DVC arrival order.
        merged: Dict[int, Header] = {}
        senders: Dict[int, int] = {}
        for m in candidates:
            for h in _parse_headers(m.body):
                op_h = h["op"]
                prev = merged.get(op_h)
                if prev is not None and not self._content_eq(prev, h):
                    if (h["view"], h["checksum_body"]) <= (
                        prev["view"], prev["checksum_body"]
                    ):
                        continue
                merged[op_h] = h
                senders[op_h] = m.header["replica"]

        if self.op > new_op:
            self.journal.truncate(new_op)
        self.op = new_op
        self.commit_max = max(self.commit_max, new_commit)

        # Install the winning content as repair targets: local prepares whose
        # body differs are stale and may not be re-proposed until repaired.
        # Wholesale replacement — targets from earlier views are obsolete.
        targets: Dict[int, Header] = {}
        for op, h in merged.items():
            if op <= self.commit_min or op > new_op:
                continue
            if not self._journal_matches(op, h):
                targets[op] = h
        self._set_targets(targets)
        for op in sorted(targets):
            if senders[op] != self.replica:
                rp = hdr.make(
                    Command.REQUEST_PREPARE, self.cluster,
                    view=v, op=op, replica=self.replica,
                )
                self.bus.send_to_replica(senders[op], Message(rp).seal())

        # Become primary of the new view.
        self.status = STATUS_NORMAL
        self.log_view = v  # tidy: monotonic=log_view — v == self.view here (DVC quorum for the view we campaign in) and log_view <= view always
        self.pipeline = []
        self.peer_stats.close_all()  # fresh peer windows for the new view
        self.request_queue = deque()
        self._queued_req = {}
        # Session-judgement floor: ops inherited from the previous view may
        # hold registers our client table hasn't applied yet — eviction
        # decisions wait until they commit (see on_request).
        self._eviction_floor = self.op
        self._persist_view()
        sv = hdr.make(
            Command.START_VIEW, self.cluster,
            view=v, replica=self.replica, op=self.op, commit=self.commit_min,
        )
        m = Message(sv, b"".join(h.to_bytes() for h in self._sv_body_headers())).seal()
        for r in range(self.replica_count):
            if r != self.replica:
                self.bus.send_to_replica(r, m)
        self._commit_journal(self.commit_max)
        self._reproposal_pipeline(v)
        # Start-view replay phase closes: the inherited suffix is
        # committed (or re-proposed and in flight) and the new view
        # serves. total_s is the primary-side blackout decomposition's
        # sum-of-phases counterpart.
        t_done = _time.perf_counter()  # tidy: allow=wall-clock — view-change observability only, never reaches replicated state
        self.view_change_stats["sv_replay_s"] = round(t_done - t_sv, 6)
        tracer.gauge(
            "vsr.view_change.sv_replay_s",
            self.view_change_stats["sv_replay_s"],
        )
        if self._vc_t0 is not None:
            self.view_change_stats["total_s"] = round(t_done - self._vc_t0, 6)
            tracer.gauge(
                "vsr.view_change.total_s", self.view_change_stats["total_s"]
            )
        self._vc_t0 = None
        self._vc_dvc_t = None
        tracer.count("vsr.view_change.elected")
        tracer.gauge("vsr.view", self.view)
        tracer.gauge("vsr.is_primary", 1)
        self.on_event("view_change", self)

    @staticmethod
    def _content_eq(a: Header, b: Header) -> bool:
        """Logical prepare identity: seal checksums differ across re-proposal
        views; what must match is (checksum_body, timestamp)."""
        return (
            a["checksum_body"] == b["checksum_body"]
            and a["timestamp"] == b["timestamp"]
        )

    def _journal_has_op(self, op: int) -> bool:
        """Header-ring presence check (no disk IO): the slot holds this op
        and its body is not recovery-classified torn."""
        slot = self.journal.slot_for_op(op)
        local = self.journal.headers.get(slot)
        return (
            local is not None and local["op"] == op and slot not in self.journal.faulty
        )

    def _journal_matches(self, op: int, h: Header) -> bool:
        """Does the local journal hold a prepare with this op and body?"""
        local = self.journal.headers.get(self.journal.slot_for_op(op))
        return (
            local is not None and local["op"] == op and self._content_eq(local, h)
        )

    def _reproposal_pipeline(self, v: int) -> None:
        """Re-propose uncommitted journal ops in the new view so they can
        collect prepare_ok quorums (reference primary repair after
        start_view; replica.zig pipeline reconstruction). Re-entrant: called
        again whenever a repaired prepare fills a gap."""
        in_pipe = {e.message.header["op"] for e in self.pipeline}
        # Staged ops are committed-in-flight: never re-propose them.
        for op in range(self.commit_staged + 1, self.op + 1):
            if op in in_pipe:
                continue
            msg = self.journal.read_prepare(op) if self._journal_has_target(op) else None
            if msg is None:
                # Fetch the gap from every peer; on arrival the old-view
                # repair path in on_prepare re-invokes this method.
                rp = hdr.make(
                    Command.REQUEST_PREPARE, self.cluster,
                    view=v, op=op, replica=self.replica,
                )
                m = Message(rp).seal()
                for r in range(self.replica_count):
                    if r != self.replica:
                        self.bus.send_to_replica(r, m)
                break
            self._drop_target(op)
            h = msg.header
            prev = self.journal.headers.get(self.journal.slot_for_op(op - 1))
            nh = hdr.make(
                Command.PREPARE, self.cluster,
                view=v, op=op, commit=self.commit_min,
                timestamp=h["timestamp"], replica=self.replica,
                operation=h["operation"], client=h["client"], request=h["request"],
                parent=(prev["checksum"] if prev is not None else 0),
            )
            prepare = Message(nh, msg.body).seal()
            self.journal.write_prepare(prepare)
            entry = Pipeline(prepare)
            entry.ok_from.add(self.replica)
            self.pipeline.append(entry)
            for r in range(self.replica_count):
                if r != self.replica:
                    self.bus.send_to_replica(r, prepare)
        self.pipeline.sort(key=lambda e: e.message.header["op"])

    def on_start_view(self, msg: Message) -> None:
        h = msg.header
        v = h["view"]
        if v < self.view or (v == self.view and self.status == STATUS_NORMAL):
            return
        # Adopting a new view truncates/overwrites journal state the
        # staged ops were read from: drain execution first (they are
        # committed — at or below the new view's commit floor).
        self._quiesce_commit_stage()
        if self._recovery_active and self.status != STATUS_NORMAL:
            tracer.count("recovery.view_adopt")
        if self._vc_t0 is not None:
            # Backup-side episode closes: the elected primary's
            # START_VIEW arrived and this replica re-enters normal.
            import time as _time

            self.view_change_stats["sv_adopt_s"] = round(
                _time.perf_counter() - self._vc_t0, 6  # tidy: allow=wall-clock — view-change observability only, never reaches replicated state
            )
            tracer.gauge(
                "vsr.view_change.sv_adopt_s",
                self.view_change_stats["sv_adopt_s"],
            )
            self._vc_t0 = None
            self._vc_dvc_t = None
        tracer.count("vsr.view_change.adopted")
        self.view = v
        self.log_view = v  # tidy: monotonic=log_view — on_start_view validated v >= self.view >= log_view before adopting
        self.status = STATUS_NORMAL
        # A deposed primary lands here directly (catch-up without a
        # local view_change episode): close its stale peer windows.
        self.peer_stats.close_all()
        tracer.gauge("vsr.view", self.view)
        tracer.gauge("vsr.is_primary", int(self.primary_index(v) == self.replica))
        self._recovery_pongs = {}
        self.last_heartbeat_tick = self.tick_count

        # Adopt the new view's log exactly: truncate our uncommitted tail
        # beyond it, then install the body headers as repair targets so any
        # stale local prepare is replaced before it can commit.
        new_op = h["op"]
        if self.op > new_op:
            self.journal.truncate(new_op)
        self.op = max(new_op, self.commit_min)  # tidy: monotonic=op — THE sanctioned regression: view-change suffix truncation to the elected log, clamped at commit_min (protomodel models this as deliver_sv log adoption)
        primary = h["replica"]
        targets: Dict[int, Header] = {}
        for sh in _parse_headers(msg.body):
            op = sh["op"]
            if op <= self.commit_min or op > new_op:
                continue
            if not self._journal_matches(op, sh):
                targets[op] = sh
        self._set_targets(targets)
        for op in sorted(targets):
            rp = hdr.make(
                Command.REQUEST_PREPARE, self.cluster,
                view=v, op=op, replica=self.replica,
            )
            self.bus.send_to_replica(primary, Message(rp).seal())
        self._persist_view()
        self._commit_journal(h["commit"])
        self.on_event("view_change", self)

    def _persist_view(self) -> None:
        st = self.superblock.state
        if st.view == self.view and st.log_view == self.log_view:
            return
        st.view = self.view
        st.log_view = self.log_view
        self.superblock.checkpoint()

    # --- execution ------------------------------------------------------

    def _realtime_ns(self) -> int:
        """Cluster-synchronized wall time for prepare timestamps
        (reference replica.zig:1323 realtime_synchronized): the Marzullo
        epoch bounds the local clock; before the first synchronization the
        raw injected clock serves (a solo cluster synchronizes to itself
        on the first window)."""
        rt = self.clock.realtime_synchronized()
        return rt if rt is not None else self.time.realtime_ns()

    def _execute(
        self, prepare: Message, replay: bool = False, build_reply: bool = True
    ):
        """Execute one committed prepare. build_reply=False (overlapped
        stage) returns a reply SPEC dict instead of a sealed Message —
        the stage serializes it through the preallocated scratch builder
        (_stage_emit)."""
        if self.aof is not None:
            # Replay included: ops whose AOF entries died in the page cache
            # (power loss after commit) are re-offered by WAL replay and
            # must fill the gap; AOF.append skips ops already recorded.
            self.aof.append(
                prepare, self.primary_index(prepare.header["view"]), self.replica
            )
        tracer.count("vsr.commits")
        with tracer.span("replica.execute"):
            results = self._execute_op(prepare)
            out = self._execute_tail(
                prepare, results, replay=replay, build_reply=build_reply
            )
        if replay:
            # Replay has no reply to race ahead of: finish the op's apply
            # sequence inline (live commit paths call _finish_commit after
            # the reply send — same per-op order either way).
            self._finish_commit()
        return out

    def _checkpoint_guarded(self) -> bool:
        """_maybe_checkpoint with grid-repair handling: the trailer write
        drains compactions, whose reads can hit a corrupt block. Returns
        False when a repair was started (commits gate; the checkpoint
        retries after repair — its content is deterministic, and the
        aborted drain job restarts identically)."""
        try:
            self._maybe_checkpoint()
            return True
        except GridReadFault as fault:
            self._checkpoint_pending = True
            self._begin_grid_repair(fault)
            return False

    def _finish_commit(self, lc=None) -> None:
        """Deferred tail of the per-op apply sequence: the state machine's
        deferred object store, then the compaction beat. Runs AFTER the
        reply hits the wire (the reply depends only on validate+post) but
        in the identical per-op order as replay — store(N) → beat(N) →
        store(N+1) — so grid allocation order stays deterministic across
        replicas and restarts (checked byte-for-byte by the storage
        checker). With the async store stage attached, the same sequence
        runs as a coalesced job on the store thread instead (jobs drain
        strictly in op order, preserving the write sequence exactly);
        submit() backpressure bounds the queue. `lc` (the op's lifecycle
        record) gets the store-queue vs store-service stamps — on this
        thread when inline, on the store thread when async."""
        sm = self.state_machine
        if self.store_executor is not None:
            tracer.op_stamp(lc, tracer.OP_STORE_SUBMIT)
            self.store_executor.submit({
                "op": getattr(self, "last_committed_op", 0),
                "store": sm.take_deferred_store(),
                "lc": lc,
            })
            return
        tracer.op_stamp(lc, tracer.OP_STORE_SUBMIT)
        tracer.op_stamp(lc, tracer.OP_STORE_START)
        sm.flush_deferred()
        sm.compact_beat()
        tracer.op_stamp(lc, tracer.OP_STORE_END)
        tracer.op_store_done(lc)

    def _execute_op(self, prepare: Message) -> bytes:
        """State-machine dispatch for one committed prepare → result
        bytes (the reply body)."""
        h = prepare.header
        op_num = h["op"]
        operation = h["operation"]
        sm = self.state_machine
        body = prepare.body
        results: bytes

        if operation >= 128:
            # Read-only view straight over the wire bytes — the state
            # machine never mutates event arrays (failing rows are copied
            # before stamping), and the old bytearray round-trip copied
            # every 1 MiB body once per commit.
            events = np.frombuffer(
                body, dtype=_event_dtype(operation, len(body))
            )
            if operation == Operation.CREATE_ACCOUNTS:
                res = sm.create_accounts(events, timestamp=h["timestamp"])
                sm.prepare_timestamp = max(sm.prepare_timestamp, h["timestamp"])
                results = res.tobytes()
            elif operation == Operation.CREATE_TRANSFERS:
                res = sm.create_transfers(events, timestamp=h["timestamp"])
                sm.prepare_timestamp = max(sm.prepare_timestamp, h["timestamp"])
                results = res.tobytes()
            elif operation == Operation.LOOKUP_ACCOUNTS:
                recs = sm.lookup_accounts(events["lo"], events["hi"])
                results = recs.tobytes()
            elif operation == Operation.LOOKUP_TRANSFERS:
                recs = sm.lookup_transfers(events["lo"], events["hi"])
                results = recs.tobytes()
            elif operation == Operation.GET_ACCOUNT_TRANSFERS:
                # Defense in depth vs malformed committed bodies: a commit
                # must never raise, or the whole cluster crash-loops.
                results = (
                    self._get_account_transfers(events[0]).tobytes() if len(events) else b""
                )
            elif operation == Operation.GET_ACCOUNT_HISTORY:
                results = (
                    self._get_account_history(events[0]).tobytes() if len(events) else b""
                )
            elif operation == Operation.QUERY_ACCOUNTS:
                results = (
                    sm.query_accounts(events[0]).tobytes() if len(events) else b""
                )
            elif operation == Operation.QUERY_TRANSFERS:
                results = (
                    sm.query_transfers(events[0]).tobytes() if len(events) else b""
                )
            else:
                results = b""
        elif operation == Operation.RECONFIGURE:
            results = b""
            rec = np.frombuffer(body, dtype=RECONFIGURE_DTYPE)
            if len(rec):
                standby_ix = int(rec[0]["standby_index"])
                target_ix = int(rec[0]["target_index"])
                if (
                    self.replica_count <= standby_ix
                    < self.replica_count + self.standby_count
                    and 0 <= target_ix < self.replica_count
                ):
                    tracer.count("mark.reconfigure_commit")
                    self.reconfigures_applied.add((standby_ix, target_ix))
                    # Epoch bump + per-slot reassignment record are
                    # deterministic (functions of the committed op stream)
                    # so WAL replay rebuilds them; durable only via
                    # checkpoints / the snapshot blob.
                    self.config_epoch += 1
                    self.slot_epoch[target_ix] = self.config_epoch
                    if self.is_standby and self.replica == standby_ix:
                        # THIS standby takes over the vacated active slot:
                        # adopt the identity durably (the superblock is the
                        # identity of the data file — a restart must come
                        # back as the active member), then start acking.
                        log.info(
                            "replica %d: promoted standby -> active slot %d",
                            self.replica, target_ix,
                        )
                        self.replica = target_ix
                        self.superblock.state.replica = target_ix
                        self.superblock.state.promoted_at_op = op_num
                        self.superblock.checkpoint()
                        self.on_event("promoted", self)
                    elif (
                        not self.is_standby
                        and self.replica == target_ix
                        and self.superblock.state.promoted_at_op == 0
                    ):
                        # The cluster gave OUR slot away (we were presumed
                        # dead; a raced restart must not split-brain the
                        # slot): retire permanently (reference epoch
                        # semantics; operator decommissions the node).
                        # promoted_at_op != 0 means WE are the promoted
                        # occupant — a duplicate committed RECONFIGURE
                        # must be a no-op, never self-retirement. (A
                        # SECOND promotion chain into the same slot is an
                        # operator-contract limitation, as in the
                        # reference's reconfiguration stub.)
                        log.warning(
                            "replica %d: slot reassigned by reconfiguration "
                            "at op %d — retiring", self.replica, op_num,
                        )
                        tracer.count("mark.replica_retired")
                        self.retired = True
                        self.status = STATUS_RECOVERING
                        self.on_event("retired", self)
        else:
            results = b""  # register / root
        return results

    def _execute_tail(
        self,
        prepare: Message,
        results: bytes,
        replay: bool = False,
        build_reply: bool = True,
    ):
        """Post-execution bookkeeping + reply: commit checksum chain,
        client-session (replicated) state, and the reply itself — built
        inline on the serial path, returned as a spec dict for the
        overlapped stage's coalesced builder when build_reply=False."""
        h = prepare.header
        op_num = h["op"]
        operation = h["operation"]
        # State hash per op: (op, committed BODY checksum, results). The
        # body checksum is view-independent (re-proposed prepares reseal
        # the header but not the body), so replicas committing DIFFERENT
        # content at one op are caught even when both batches happen to
        # produce identical result codes (e.g. two all-OK batches). Seal
        # checksums stay excluded for exactly the re-proposal reason.
        self.commit_checksums[op_num] = hdr.checksum(
            op_num.to_bytes(8, "little")
            + int(h["checksum_body"]).to_bytes(16, "little")
            + results
        )
        # One compaction beat per committed op, in the apply sequence via
        # _finish_commit (after the reply send) so WAL replay re-runs the
        # identical beat sequence (deterministic grid allocation order —
        # reference forest.compact per op, forest.zig:319).
        self.committed_timestamp_max = max(
            self.committed_timestamp_max, int(h["timestamp"])
        )
        self.last_committed_op = op_num
        self.on_event("commit", self)

        # Client-table update is replicated state: every replica applies it
        # at commit (reference client_sessions.zig + commit_op :3777-3815).
        client = h["client"]
        reply: Optional[Message] = None
        spec: Optional[dict] = None
        if client != 0:
            if build_reply:
                with tracer.span("stage.reply"):
                    # make_sealed: one C call (fields + both MACs) on the
                    # native datapath, make+seal on the fallback.
                    reply = hdr.make_sealed(
                        Command.REPLY, self.cluster, body=results,
                        view=self.view, op=op_num, commit=op_num,
                        timestamp=h["timestamp"], client=client,
                        request=h["request"], replica=self.replica,
                        operation=operation,
                    )
            else:
                spec = {
                    "view": self.view, "op": op_num,
                    "timestamp": int(h["timestamp"]), "client": client,
                    "request": int(h["request"]), "replica": self.replica,
                    "operation": operation, "cluster": self.cluster,
                    "body": results,
                }
            if operation == Operation.REGISTER:
                if len(self.clients) >= self.config.clients_max:
                    self._evict_lru_client()
                self.clients[client] = ClientSession(session=op_num)
                tracer.gauge("vsr.sessions", len(self.clients))
            sess = self.clients.get(client)
            if sess is not None:
                sess.request = h["request"]
                # LRU maintenance: this commit makes the session the most
                # recently active — move it to the dict's end (O(1); a
                # fresh REGISTER insert is already there). Replicated:
                # applied at commit in op order on every replica.
                sess.last_op = int(op_num)
                self.clients[client] = self.clients.pop(client)
                # build_reply=False: _stage_emit fills this in right after
                # this tail returns; a resend in the window simply gets
                # nothing (indistinguishable from reply loss — the client
                # retries).
                sess.reply = reply
        if replay:
            return None
        return reply if build_reply else spec

    def _get_account_transfers(self, f: np.void) -> np.ndarray:
        return self.state_machine.get_account_transfers(
            account_id=int(f["account_id_lo"]) | (int(f["account_id_hi"]) << 64),
            timestamp_min=int(f["timestamp_min"]),
            timestamp_max=int(f["timestamp_max"]),
            limit=int(f["limit"]),
            flags=int(f["flags"]),
        )

    def _get_account_history(self, f: np.void) -> np.ndarray:
        rows = self.state_machine.get_account_history(
            account_id=int(f["account_id_lo"]) | (int(f["account_id_hi"]) << 64),
            timestamp_min=int(f["timestamp_min"]),
            timestamp_max=int(f["timestamp_max"]),
            limit=int(f["limit"]),
            flags=int(f["flags"]),
        )
        out = np.zeros(len(rows), dtype=types.ACCOUNT_BALANCE_DTYPE)
        for i, (ts, dp, dpo, cp, cpo) in enumerate(rows):
            out[i]["timestamp"] = ts
            for name, v in (
                ("debits_pending", dp), ("debits_posted", dpo),
                ("credits_pending", cp), ("credits_posted", cpo),
            ):
                out[i][name + "_lo"] = v & ((1 << 64) - 1)
                out[i][name + "_hi"] = v >> 64
        return out

    # --- checkpoint -----------------------------------------------------

    def _maybe_checkpoint(self) -> None:
        interval = self.config.checkpoint_interval
        if self.commit_min == 0 or self.commit_min % interval != 0:
            return
        if self.commit_min <= self.superblock.state.op_checkpoint:
            return
        if self.grid is None:
            # No durable grid zone (journal-only fixture): a trailer written
            # to the in-memory grid would not survive restart — advancing
            # the superblock past state we cannot reload would brick open().
            return
        log.info("replica %d: checkpoint at op %d", self.replica, self.commit_min)
        tracer.count("replica.checkpoint")
        # The trailer must capture every op ≤ commit_min's store and beat:
        # drain the async store stage first. A job parked on a corrupt
        # block re-raises its fault here so _checkpoint_guarded applies
        # the identical gate/retry path as an inline checkpoint fault.
        if self.store_executor is not None:
            self.store_executor.drain()
            if self.store_executor.parked:
                raise self.store_executor.fault
        if self.aof is not None:
            self.aof.sync()
        # Trailer write flushes LSM memtables into grid blocks and chunks
        # the checkpoint blob into reserved blocks; everything must be
        # durable before the superblock may reference it.
        trailer_block = self._trailer_write()
        self.storage.sync()
        st = self.superblock.state
        st.op_checkpoint = self.commit_min
        st.commit_min = self.commit_min
        st.commit_max = self.commit_max
        st.view = self.view
        st.log_view = self.log_view
        st.prepare_timestamp = self.committed_timestamp_max
        st.commit_timestamp = self.state_machine.commit_timestamp
        st.config_epoch = self.config_epoch
        st.trailer_block = trailer_block
        self.superblock.checkpoint()
        # The checkpoint is durable: staged grid frees (tables replaced by
        # compaction since the last checkpoint, plus the previous trailer's
        # blocks) may now be reused.
        self.state_machine.grid.commit_releases()
        self.on_event("checkpoint", self)

    def _save_snapshot(self) -> bytes:
        return snapshot.encode(self)

    def _load_snapshot(self, blob: bytes) -> None:
        tracer.count("mark.state_sync_install")
        snapshot.install(self, blob)

    # --- checkpoint trailer (grid-resident checkpoint state) ------------
    #
    # The checkpoint blob lives in grid blocks referenced from the
    # superblock (reference checkpoint_trailer.zig:459): chunks in data
    # blocks + one index block listing them. ONE data file — no side
    # files. Crash discipline: the previous trailer's blocks are only
    # STAGE-released (freed after the new superblock is durable), and the
    # new trailer occupies freshly acquired blocks, so a crash on either
    # side of the superblock write recovers to a complete trailer.

    BLOCK_TYPE_TRAILER = 4
    _TRAILER_HEAD = np.dtype(
        [("count", "<u4"), ("_pad", "<u4"), ("blob_len", "<u8"),
         ("cks_lo", "<u8"), ("cks_hi", "<u8")]
    )

    def _trailer_write(self) -> int:
        """Encode the checkpoint blob into reserved grid blocks; returns
        the trailer index block. Converges on the reservation size (the
        encoded free set accounts the trailer's own blocks, which feeds
        back into the blob length)."""
        grid = self.state_machine.grid
        payload_max = grid.payload_max
        fences_max = (payload_max - self._TRAILER_HEAD.itemsize) // 4
        # Stage-release the previous trailer (reclaimed post-durability).
        for b in self._trailer_blocks:
            grid.release(b)
        # Trailer blocks come from the TOP of the grid (acquire_high) and
        # are excluded from the encoded free set: per-replica trailer
        # placement history must never perturb the deterministic content
        # layout the storage checker byte-compares. The blob is therefore
        # independent of the reservation — one encode suffices.
        blob = snapshot.encode(self)
        need = -(-len(blob) // payload_max) + 1  # chunks + index block
        assert need - 1 <= fences_max, "checkpoint trailer exceeds one index block"
        reserved = [grid.free_set.acquire_high() for _ in range(need)]
        index_block, chunks = reserved[0], reserved[1:]
        for i, b in enumerate(chunks):
            grid.write_block_at(
                b, blob[i * payload_max : (i + 1) * payload_max],
                self.BLOCK_TYPE_TRAILER,
            )
        head = np.zeros((), dtype=self._TRAILER_HEAD)
        head["count"] = len(chunks)
        head["blob_len"] = len(blob)
        c = hdr.checksum(blob)
        head["cks_lo"] = c & ((1 << 64) - 1)
        head["cks_hi"] = c >> 64
        grid.write_block_at(
            index_block,
            head.tobytes() + np.array(chunks, dtype=np.uint32).tobytes(),
            self.BLOCK_TYPE_TRAILER,
        )
        self._trailer_blocks = reserved
        return index_block

    def _mark_trailer_allocated(self) -> None:
        grid = self.state_machine.grid
        for b in self._trailer_blocks:
            grid.free_set.free[b] = False

    def _trailer_read(self, index_block: int) -> bytes:
        """Read the checkpoint blob back from its trailer blocks; also
        records the trailer block set (so the next checkpoint can
        stage-release it)."""
        blob, self._trailer_blocks = self._trailer_blob(index_block)
        return blob

    def _trailer_blob(self, index_block: int) -> Tuple[bytes, List[int]]:
        """The checkpoint blob of the trailer at `index_block` and its
        block set, read without changing the replica."""
        grid = self.state_machine.grid
        payload = grid.read_block(index_block)
        head = np.frombuffer(
            payload[: self._TRAILER_HEAD.itemsize], dtype=self._TRAILER_HEAD
        )[0]
        count = int(head["count"])
        chunks = np.frombuffer(
            payload[self._TRAILER_HEAD.itemsize : self._TRAILER_HEAD.itemsize + 4 * count],
            dtype=np.uint32,
        )
        blob = b"".join(grid.read_block(int(b)) for b in chunks)
        blob = blob[: int(head["blob_len"])]
        want = int(head["cks_lo"]) | (int(head["cks_hi"]) << 64)
        if len(blob) != int(head["blob_len"]) or hdr.checksum(blob) != want:
            raise IOError("checkpoint trailer corrupt")
        return blob, [index_block] + [int(b) for b in chunks]
