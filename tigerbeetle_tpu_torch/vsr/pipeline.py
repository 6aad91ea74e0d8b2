"""Overlapped pipeline stages: commit execution and the deferred LSM
store off the event loop.

The serial replica commits inline — the asyncio event loop parses a
request, writes the WAL, executes the state machine, stores, and only
then reads the next socket. Under load that strictly alternates network
and compute: the WAL writer thread idles while the loop executes, and
sockets back up while the state machine posts balances.

`CommitExecutor` mirrors the `WalWriter` shape (vsr/journal.py): one
dedicated worker thread, a condition-variable queue, completions posted
back to the event loop. The replica hands it COMMITTED prepares (commit
order is fixed before anything is submitted — quorum on the primary, the
commit number on backups) and the stage drains strictly in op order, so
execution of op N overlaps the networking, WAL durability, and quorum
accounting of ops N+1..N+k without perturbing determinism (the paper's
core claim: the state machine is a pure function of (state, ordered
batch)).

Protocol with the replica (vsr/replica.py `_stage_*`), all on the worker
thread:

  - `process(job) -> (publish, leftovers, ok)`: execute one job. On
    success the replica posts the job's completion itself via
    `complete()` — EARLY, right after the reply is built and before the
    op's deferred store/compaction beat, mirroring the serial path's
    reply-first design. ok=False PARKS the stage on a `GridReadFault`;
    `leftovers` are unexecuted jobs to push back to the queue head, and
    `publish` (the faulted job, or a finish-fault marker for an op whose
    completion already went out) is made visible only AFTER the park
    flag is set, so the event loop's `reset()` cannot race it.
  - `flush() -> (publish, leftovers, ok)`: settle the held cross-batch
    dispatch window (up to commit_depth jobs) once the queue runs dry;
    `leftovers` are window jobs a mid-window fault left unexecuted.
  - `complete(job)` appends to the thread-safe done deque and pokes the
    event loop, which applies completions in op order via `pop_done()`.

Fail-stop discipline matches WalWriter: any non-`GridReadFault`
exception posts a poison callback so the event loop crashes loudly
instead of wedging with a silently dead stage.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.tidy import runtime as tidy_runtime

# Max jobs popped per cycle (keeps park/reset bookkeeping bounded).
RUN_MAX = 8


def _timed_wait(cond: threading.Condition, event: str) -> None:
    """One condition wait, recorded as stage idle/stall time when tracing
    is on (the per-stage stall/idle registry rows — the quantity that
    decides whether a stage overlaps usefully or just time-slices)."""
    if not tracer.enabled():
        cond.wait()
        return
    t0 = time.perf_counter_ns()  # tidy: allow=wall-clock — tracing only, never reaches state
    cond.wait()
    tracer.observe(event, time.perf_counter_ns() - t0)  # tidy: allow=wall-clock — tracing only, never reaches state


class CommitExecutor:
    def __init__(
        self,
        process: Callable[[dict], Tuple[Optional[dict], List[dict], bool]],
        post: Callable[[Callable[[], None]], None],
        flush: Optional[
            Callable[[], Tuple[Optional[dict], List[dict], bool]]
        ] = None,
        notify: Optional[Callable[[], None]] = None,
        thread_init: Optional[Callable[[], None]] = None,
    ) -> None:
        self._process = process
        self._flush = flush
        # Run once on the worker thread before its first job (the
        # replica binds the thread to its state machine's CUDA device: a
        # fresh thread's current device is 0).
        self._thread_init = thread_init
        self._post = post
        # Posted to the loop after completions land on the done deque —
        # the replica's completion drainer (applies state in op order).
        self._notify = notify if notify is not None else (lambda: None)
        self._cond = tidy_runtime.make_condition("commit.cond")
        self._pending: deque = deque()  # tidy: guarded-by=_cond
        # tidy: atomic — GIL-atomic deque handoff: worker appends, loop pops
        self._done: deque = deque()
        self._busy = False  # tidy: guarded-by=_cond
        self._parked = False  # tidy: guarded-by=_cond
        self._stopped = False  # tidy: guarded-by=_cond
        self._thread = threading.Thread(
            target=self._run, name="commit-executor", daemon=True
        )
        self._thread.start()

    # --- event-loop side -------------------------------------------------

    def submit(self, job: dict) -> None:
        tidy_runtime.assert_role("loop")
        with self._cond:
            self._pending.append(job)
            tracer.gauge("pipeline.commit.depth", len(self._pending))
            self._cond.notify_all()

    def pop_done(self) -> Optional[dict]:
        """Next completed job, in completion (= op) order; None when empty.
        Thread-safe: the worker appends, the event loop pops."""
        tidy_runtime.assert_role("loop")
        try:
            return self._done.popleft()
        except IndexError:
            return None

    def drain(self) -> None:
        """Block until every submitted job has been processed (including a
        held double-buffered job) or the stage parked on a fault. Apply
        completions via pop_done() after — drain orders EXECUTION, the
        loop still owns state application."""
        with self._cond:
            while (self._pending or self._busy) and not self._parked:
                if self._stopped:
                    raise RuntimeError(
                        "commit executor fail-stopped with jobs still queued"
                    )
                self._cond.wait()

    def reset(self) -> List[dict]:
        """Reclaim unprocessed jobs and unpark (grid-repair recovery: the
        event loop re-derives the commit stream from the journal, so the
        queue must not replay stale jobs)."""
        with self._cond:
            out = list(self._pending)
            self._pending.clear()
            self._parked = False
            self._cond.notify_all()
        return out

    @property
    def parked(self) -> bool:  # tidy: allow=unlocked-access — racy read by design, re-checked under the lock by every consumer
        return self._parked

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    # --- worker-thread side ----------------------------------------------

    def complete(self, job: dict) -> None:  # tidy: thread=commit
        """Publish one completion (called by `process` the moment an op's
        reply is ready — before its deferred storage work)."""
        tidy_runtime.assert_role("commit")
        self._done.append(job)
        self._post(self._notify)

    def _publish_parked(self, publish: Optional[dict], rest: List[dict]) -> None:
        """Park and make the fault visible in ONE lock scope: any thread
        that observes parked (drain / quiesce) must also find the fault
        on the done deque, and the loop can only learn of the fault via
        that deque — so its reset() always sees the fully parked state."""
        with self._cond:
            self._pending.extendleft(reversed(rest))
            if publish is not None:
                self._done.append(publish)
            self._parked = True
            self._cond.notify_all()
        if publish is not None:
            self._post(self._notify)

    def _poison(self, err: BaseException) -> None:
        def _raise() -> None:
            raise RuntimeError(f"commit executor stage failed: {err!r}") from err

        # Flight recorder: the op records leading up to a stage poison
        # are the post-hoc causality for the crash — dump before the
        # loop re-raises.
        tracer.flight_exception(f"commit stage: {err!r}")
        self._post(_raise)
        with self._cond:
            self._stopped = True
            self._busy = False
            self._cond.notify_all()

    def _run(self) -> None:
        tidy_runtime.stamp("commit")
        if self._thread_init is not None:
            self._thread_init()
        while True:
            with self._cond:
                while (not self._pending or self._parked) and not self._stopped:
                    _timed_wait(self._cond, "pipeline.commit.idle")
                if self._stopped:
                    return
                run = [
                    self._pending.popleft()
                    for _ in range(min(RUN_MAX, len(self._pending)))
                ]
                self._busy = True
            try:
                for i, job in enumerate(run):
                    publish, leftovers, ok = self._process(job)
                    if not ok:
                        self._publish_parked(publish, leftovers + run[i + 1 :])
                        break
                else:
                    with self._cond:
                        queue_empty = not self._pending
                    if queue_empty and self._flush is not None:
                        publish, leftovers, ok = self._flush()
                        if not ok:
                            self._publish_parked(publish, leftovers)
            except Exception as e:  # noqa: BLE001 — fail-stop, never wedge
                self._poison(e)
                return
            with self._cond:
                self._busy = False
                self._cond.notify_all()


class StoreExecutor:
    """Deferred LSM store stage: per-op coalesced groove/index write jobs
    plus compaction beats, drained strictly in op order on one worker
    thread (the WalWriter/CommitExecutor pattern, third stage).

    Store durability is a pure function of the committed batch, so it can
    trail commit order without touching determinism: the worker preserves
    the serial apply sequence store(N) → beat(N) → store(N+1) → …, which
    is the only thing grid allocation order (and therefore checkpoint
    bytes) depends on. Readers synchronize through `drain()` — the state
    machine's `store_barrier()` — before consulting anything the queued
    jobs will write (read-your-writes).

    Protocol with the replica:

      - `process(job) -> Optional[dict]`: run one job on the worker; None
        on success, the job itself (fault attached) on a `GridReadFault`
        — the stage PARKS, the job is published on the done deque, and
        `fault` exposes the exception so a reader blocked in `drain()`
        can re-raise it instead of reading half-stored state.
      - `submit()` applies backpressure: it blocks while the queue is at
        `depth_max` (bounds job RAM) — but never while parked; the
        replica's commit gates (`_finish_pending`) take over there.
      - `resume(job)` requeues the repaired faulted job at the HEAD and
        unparks (grid-repair recovery); `reset()` discards the queue
        outright (state sync replaced the state machine wholesale).

    Fail-stop discipline matches the other stages: any non-GridReadFault
    exception posts a poison callback so the event loop crashes loudly.
    """

    DEPTH_MAX = 8  # queued store jobs (~1 MiB of records each, worst case)

    def __init__(
        self,
        process: Callable[[dict], Optional[dict]],
        post: Callable[[Callable[[], None]], None],
        notify: Optional[Callable[[], None]] = None,
        depth_max: int = DEPTH_MAX,
        idle_work: Optional[Callable[[], bool]] = None,
        thread_init: Optional[Callable[[], None]] = None,
    ) -> None:
        self._process = process
        self._thread_init = thread_init  # as CommitExecutor's
        self._post = post
        self._notify = notify if notify is not None else (lambda: None)
        self._depth_max = depth_max
        # Optional queue-idle poll (device query-index pipeline and
        # compaction read-ahead): called with the lock RELEASED while the
        # queue is empty; returns True while it may have more to do. Must
        # be content-neutral and idempotent — it only pulls deferred
        # device→host transfers forward (QueryKeyRun.materialize) or
        # warms upcoming compaction-input blocks into the grid cache
        # (sm.compact_prefetch_one), never changes state bytes — so it
        # needs no drain()/barrier coordination. This is the sanctioned
        # place for TIMING-dependent acceleration: anything that would
        # alter bytes (like the compaction quota) must key off committed
        # state instead.
        self._idle_work = idle_work
        self._cond = tidy_runtime.make_condition("store.cond")
        self._pending: deque = deque()  # tidy: guarded-by=_cond
        # tidy: atomic — GIL-atomic deque handoff: worker appends, loop pops
        self._done: deque = deque()
        # The job popped for processing (in-flight): part of the pending
        # write buffer until its store phase lands (job["stored"]).
        self._current: Optional[dict] = None  # tidy: guarded-by=_cond
        self._busy = False  # tidy: guarded-by=_cond
        self._parked = False  # tidy: guarded-by=_cond
        self._stopped = False  # tidy: guarded-by=_cond
        # Published under _cond by the worker; the commit thread reads it
        # lock-free AFTER drain() returned parked (store_barrier) — the
        # park flag is the publication barrier.
        self.fault: Optional[BaseException] = None  # tidy: guarded-by=_cond
        self._thread = threading.Thread(
            target=self._run, name="store-executor", daemon=True
        )
        self._thread.start()

    # --- producer side (commit thread / event loop) ----------------------

    def submit(self, job: dict) -> None:  # tidy: thread=commit|loop
        tidy_runtime.assert_role("commit", "loop")
        with self._cond:
            while (
                len(self._pending) >= self._depth_max
                and not self._parked
                and not self._stopped
            ):
                # Backpressure STALL: the commit thread is blocked on the
                # store stage — the registry row that shows whether the
                # store thread is the pipeline's bottleneck.
                _timed_wait(self._cond, "pipeline.store.stall")
            if self._stopped:
                # Shutdown race: the commit executor may settle its last
                # in-flight run after stop() was issued. Dropping the job
                # is safe — the WAL holds the committed prepares, and
                # replay re-derives the store deterministically at the
                # next open().
                return
            self._pending.append(job)
            tracer.gauge("pipeline.store.depth", len(self._pending))
            self._cond.notify_all()

    def drain(self) -> None:  # tidy: thread=commit|loop
        """Block until every queued job ran, or the stage parked on a
        fault (check `parked`/`fault` after — a parked stage holds jobs
        that will resume after grid repair)."""
        with self._cond:
            while (self._pending or self._busy) and not self._parked:
                if self._stopped:
                    raise RuntimeError(
                        "store executor fail-stopped with jobs still queued"
                    )
                self._cond.wait()

    def resume(self, job: dict) -> None:
        """Requeue the repaired faulted job at the queue head and unpark."""
        with self._cond:
            self._pending.appendleft(job)
            self._parked = False
            self.fault = None
            self._cond.notify_all()

    def reset(self) -> List[dict]:
        """Discard every queued job and unpark (state sync: the installed
        checkpoint supersedes whatever the jobs would have stored). Waits
        for an in-flight job to finish first — it must not still be
        mutating the state machine the caller is about to replace."""
        with self._cond:
            out = list(self._pending)
            self._pending.clear()  # first: the worker must not pop more
            while self._busy and not self._stopped:
                self._cond.wait()
            self._done.clear()
            self._parked = False
            self.fault = None
            self._cond.notify_all()
        return out

    def pop_done(self) -> Optional[dict]:
        tidy_runtime.assert_role("loop")
        try:
            return self._done.popleft()
        except IndexError:
            return None

    def unapplied_stores(self) -> List[tuple]:  # tidy: thread=commit|loop
        """Snapshot of the PENDING WRITE BUFFER: (recs, ts) store
        payloads of queued + in-flight jobs whose index/log writes have
        not landed yet. Readers racing the stage consult this first,
        then the durable index — a job leaves this list only AFTER its
        store phase completed (process sets job["stored"] before its
        beat), so every committed write is visible in at least one of
        the two at any instant (read-your-writes without a drain)."""
        with self._cond:
            jobs = list(self._pending)
            if self._current is not None:
                jobs.insert(0, self._current)
        return [
            j["store"] for j in jobs
            if j.get("store") is not None and not j.get("stored")
        ]

    @property
    def parked(self) -> bool:  # tidy: allow=unlocked-access — racy read by design, re-checked under the lock by every consumer
        return self._parked

    @property
    def idle(self) -> bool:  # tidy: thread=commit|loop
        with self._cond:
            return not self._pending and not self._busy and not self._parked

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    # --- worker-thread side ----------------------------------------------

    def _poison(self, err: BaseException) -> None:
        def _raise() -> None:
            raise RuntimeError(f"store executor stage failed: {err!r}") from err

        tracer.flight_exception(f"store stage: {err!r}")
        self._post(_raise)
        with self._cond:
            self._stopped = True
            self._busy = False
            self._cond.notify_all()

    def _run(self) -> None:
        tidy_runtime.stamp("store")
        if self._thread_init is not None:
            self._thread_init()
        # Idle work stays armed while the last poll reported more pending
        # (or a job just ran, which may have queued new lazy runs); once
        # it reports dry the worker blocks on the condition until the
        # next submit — no spinning.
        idle_armed = self._idle_work is not None
        while True:
            with self._cond:
                while (not self._pending or self._parked) and not self._stopped:
                    if idle_armed and not self._parked:
                        break  # poll outside the lock, then re-check
                    _timed_wait(self._cond, "pipeline.store.idle")
                if self._stopped:
                    return
                if not self._pending or self._parked:
                    job = None
                else:
                    job = self._pending.popleft()
                    self._current = job
                    self._busy = True
                    self._cond.notify_all()  # submit()'s backpressure wait
            if job is None:
                try:
                    with tracer.span("pipeline.store.prefetch"):
                        idle_armed = bool(self._idle_work())
                except Exception as e:  # noqa: BLE001 — fail-stop, never wedge
                    self._poison(e)
                    return
                continue
            idle_armed = self._idle_work is not None
            try:
                publish = self._process(job)
            except Exception as e:  # noqa: BLE001 — fail-stop, never wedge
                self._poison(e)
                return
            with self._cond:
                self._current = None
                if publish is not None:
                    # Park + publish in ONE lock scope (CommitExecutor's
                    # discipline): any thread observing parked also finds
                    # the fault set, and drain() wakes to re-raise it.
                    self._done.append(publish)
                    self._parked = True
                    self.fault = publish.get("fault")
                self._busy = False
                self._cond.notify_all()
            if publish is not None:
                self._post(self._notify)
