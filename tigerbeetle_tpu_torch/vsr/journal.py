"""WAL journal: two on-disk rings (redundant headers + prepares).

Mirrors upstream src/vsr/journal.zig:18-67 — slot = op % slot_count;
the headers ring holds each slot's 256-byte prepare header redundantly so
recovery can distinguish a torn prepare body from a missing one; the
prepares ring holds full messages. Recovery classifies each slot by
cross-checking both rings (journal.zig recovery cases, simplified to the
decision table that matters for a ring that is never reused before
checkpoint: valid / torn / missing).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.io.storage import Zone
from tigerbeetle_tpu_torch.tidy import runtime as tidy_runtime
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header, Message


class WalWriter:
    """WAL durable-write thread (reference replica.zig:3034: replication
    overlaps the WAL write; acks wait for durability).

    `submit(segments, cb)` queues a slot write — segments is a list of
    `(offset, chunks, durable)`; durable segments go through
    `storage.write_durable` — an O_DIRECT|O_DSYNC pwrite on FileStorage,
    durable at return, GIL released for the DMA — buffered segments (the
    redundant header ring, which acks never wait for) through plain
    `storage.write`, keeping even that pwrite's writeback stalls off the
    event loop. `cb` is posted to the event loop after the entry's
    writes. `barrier(cb)` posts `cb` once every previously queued write
    is durable (duplicate-prepare re-acks). When the storage has no
    direct fd, the thread falls back to the group-commit shape: buffered
    writes for the whole popped batch, ONE fdatasync, then the callbacks.

    Why not buffered+fdatasync always (a group sync): fdatasync
    flushes every dirty page of the data file — grid blocks included —
    and concurrent pwrites stall behind that writeback, which measured
    3-4x slower per commit under sustained load. Direct writes keep WAL
    durability off the page cache entirely.
    """

    def __init__(self, storage, post: Callable[[Callable[[], None]], None]) -> None:
        self._storage = storage
        self._post = post
        self._cond = tidy_runtime.make_condition("wal.cond")
        # (segments, cb); segments None = barrier, else a list of
        # (offset, chunks, durable) writes performed in order.
        self._pending: List[tuple] = []  # tidy: guarded-by=_cond
        self._busy = False  # tidy: guarded-by=_cond
        self._stopped = False  # tidy: guarded-by=_cond
        self._thread = threading.Thread(
            target=self._run, name="wal-writer", daemon=True
        )
        self._thread.start()

    def submit(self, segments, cb: Callable[[], None], lc=None) -> None:
        """Queue one slot write; `lc` (optional tracer.OpRecord) gets its
        WAL write-start/durable stamps on the writer thread — the
        queue-wait vs write split of the lifecycle decomposition."""
        tidy_runtime.assert_role("loop")
        with self._cond:
            self._pending.append((segments, cb, lc))
            tracer.gauge("pipeline.wal.depth", len(self._pending))
            self._cond.notify_all()

    def barrier(self, cb: Callable[[], None]) -> None:
        with self._cond:
            self._pending.append((None, cb, None))
            self._cond.notify_all()

    def drain(self) -> None:
        """Block until every queued write has reached the disk. Callbacks
        may still be pending in the event loop — drain() orders WRITES
        (e.g. before zeroing a truncated slot), not acks. Raises if the
        writer fail-stopped: waiting on a dead thread would wedge the
        event loop forever AND block the queued poison callback that
        exists to report exactly this failure."""
        with self._cond:
            while self._pending or self._busy:
                if self._stopped:
                    raise RuntimeError(
                        "WAL writer fail-stopped with writes still queued"
                    )
                self._cond.wait()

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def _run(self) -> None:
        from tigerbeetle_tpu_torch.vsr.pipeline import _timed_wait

        tidy_runtime.stamp("wal")
        while True:
            with self._cond:
                while not self._pending and not self._stopped:
                    _timed_wait(self._cond, "pipeline.wal.idle")
                if self._stopped and not self._pending:
                    return
                batch, self._pending = self._pending, []
                self._busy = True
            try:
                # wal.write spans run ON the writer thread: the WAL row in
                # the Perfetto timeline, and the durable-write latency
                # histogram (as opposed to stage.wal, the loop-side
                # enqueue cost).
                # Buffered segments (the redundant header ring; every
                # segment on the no-direct path) go through write_batch:
                # on FileStorage + busio that is ONE GIL-releasing native
                # pwritev per entry/batch instead of a Python pwrite per
                # chunk (docs/NATIVE_DATAPATH.md WAL ring writes).
                write_batch = getattr(self._storage, "write_batch", None)

                def _flat(segs):
                    out = []
                    for offset, chunks, _durable in segs:
                        pos = offset
                        for c in chunks:
                            out.append((pos, c))
                            pos += len(c)
                    return out

                if getattr(self._storage, "supports_direct", False):
                    for segments, cb, lc in batch:
                        tracer.op_stamp(lc, tracer.OP_WAL_WRITE)
                        with tracer.span("wal.write"):
                            buffered = []
                            for offset, chunks, durable in segments or ():
                                if durable:
                                    self._storage.write_durable(offset, chunks)
                                else:
                                    buffered.append((offset, chunks, durable))
                            if buffered:
                                if write_batch is not None:
                                    write_batch(_flat(buffered))
                                else:
                                    for pos, c in _flat(buffered):
                                        self._storage.write(pos, c)
                        tracer.op_stamp(lc, tracer.OP_WAL_DURABLE)
                        self._post(cb)
                else:
                    with tracer.span("wal.write"):
                        flat = []
                        for segments, _cb, lc in batch:
                            tracer.op_stamp(lc, tracer.OP_WAL_WRITE)
                            flat.extend(_flat(segments or ()))
                        if flat:
                            if write_batch is not None:
                                write_batch(flat)
                            else:
                                for pos, c in flat:
                                    self._storage.write(pos, c)
                            self._storage.sync()
                    for _segments, cb, lc in batch:
                        # Group-commit shape: the batch is durable at the
                        # shared sync, so every entry's write ends here.
                        tracer.op_stamp(lc, tracer.OP_WAL_DURABLE)
                        self._post(cb)
            except Exception as e:  # noqa: BLE001 — fail-stop, never wedge
                # A failed WAL write means acks can never be granted again:
                # post a poison callback so the event loop fail-stops loudly
                # (silently dying here would wedge the replica — no acks,
                # no crash, no log line).
                err = e

                def _poison() -> None:
                    raise RuntimeError(f"WAL durable write failed: {err!r}") from err

                tracer.flight_exception(f"wal: {err!r}")
                self._post(_poison)
                with self._cond:
                    self._stopped = True
                    self._busy = False
                    self._cond.notify_all()
                return
            with self._cond:
                self._busy = False
                self._cond.notify_all()


class Journal:
    def __init__(self, storage, zone: Zone, slot_count: int, message_size_max: int) -> None:
        self.storage = storage
        self.zone = zone
        self.slot_count = slot_count
        self.message_size_max = message_size_max
        # op currently durable in each slot (in-memory mirror of the ring).
        self.headers: Dict[int, Header] = {}  # slot -> prepare header
        self.dirty: set[int] = set()
        self.faulty: set[int] = set()
        # Async WAL writer (set by the server runtime; None = sync writes).
        self.writer: Optional[WalWriter] = None
        # slot -> Message queued on the writer but not yet on disk:
        # read-your-writes for read_prepare (a backup may commit an op via
        # a heartbeat while its body write is still in the queue).
        self.inflight: Dict[int, Message] = {}
        # Highest prepare timestamp ever journaled (incl. uncommitted):
        # the primary's timestamp floor, so recovery/view-change can never
        # assign a new prepare a timestamp at or below an in-flight one.
        self.timestamp_max = 0

    def slot_for_op(self, op: int) -> int:
        return op % self.slot_count

    # --- write ----------------------------------------------------------

    def can_write(self, op: int) -> bool:
        """A slot may only be (over)written by the same or a newer op.

        Guards the ring-wrap hazard (reference journal slot reuse asserts):
        a stale re-delivered prepare or late repair response for op k must
        never clobber slot k % slot_count once it holds op k + slot_count.
        """
        h = self.headers.get(self.slot_for_op(op))
        return h is None or h["op"] <= op

    def write_prepare(self, message: Message, sync: bool = True, lc=None) -> None:
        # Synchronous path: enqueue == write start (no queue), durable at
        # return — the lifecycle decomposition degenerates cleanly.
        tracer.op_stamp(lc, tracer.OP_WAL_ENQUEUE)
        tracer.op_stamp(lc, tracer.OP_WAL_WRITE)
        with tracer.span("journal.write_prepare"):
            self._write_prepare(message, sync)
        tracer.op_stamp(lc, tracer.OP_WAL_DURABLE)

    def _slot_prologue(self, message: Message, write_header_ring: bool = True) -> tuple:
        """Shared bookkeeping for BOTH write paths (sync and async): the
        two must stay bit-identical for recovery — asserts, header-ring
        mirror, timestamp floor, dirty/faulty clearing. The async path
        passes write_header_ring=False and queues that (buffered) write
        on the writer thread instead, so a writeback-stalled pwrite can
        never block the event loop. Returns (slot, hraw, body base
        offset)."""
        assert message.header["command"] == Command.PREPARE
        op = message.header["op"]
        assert self.can_write(op), (
            f"slot {self.slot_for_op(op)} holds newer op "
            f"{self.headers[self.slot_for_op(op)]['op']} > {op}"
        )
        slot = self.slot_for_op(op)
        hraw = message.header.to_bytes()
        assert HEADER_SIZE + len(message.body) <= self.message_size_max
        if write_header_ring:
            self.storage.write(
                self.zone.wal_headers_offset + slot * HEADER_SIZE, hraw
            )
        self.headers[slot] = message.header.copy()
        self.timestamp_max = max(self.timestamp_max, int(message.header["timestamp"]))
        self.dirty.discard(slot)
        self.faulty.discard(slot)
        return slot, hraw, self.zone.wal_prepares_offset + slot * self.message_size_max

    def _write_prepare(self, message: Message, sync: bool = True) -> None:
        """Durably store a prepare in its slot (body ring then header ring;
        reference replica.zig:8454 writes sectors of both rings)."""
        # A queued ASYNC write for this slot must never land after this
        # synchronous overwrite (it would clobber a re-proposed prepare
        # that was already acked): order the queue ahead of us.
        self._drain_writer()
        slot, hraw, base = self._slot_prologue(message)
        self.inflight.pop(slot, None)
        # Header and body written separately — concatenating would copy the
        # ~1 MiB body once per prepare for nothing.
        self.storage.write(base, hraw)
        if message.body:
            self.storage.write(base + HEADER_SIZE, message.body)
        if sync:
            self.storage.sync()

    def write_prepare_async(
        self, message: Message, on_durable: Callable[[], None], lc=None
    ) -> None:
        """Queue a prepare's durable body write on the WAL writer thread;
        `on_durable` is posted to the event loop once the slot is on disk
        (ack-after-durable). The redundant header ring is written buffered
        here — recovery treats the BODY as authoritative when the ring is
        torn (classified `dirty`, ring rewritten), so acks need only the
        body durable."""
        assert self.writer is not None
        tracer.op_stamp(lc, tracer.OP_WAL_ENQUEUE)
        with tracer.span("stage.wal"):
            slot, hraw, base = self._slot_prologue(message, write_header_ring=False)
            self.inflight[slot] = message

            def _done() -> None:
                if self.inflight.get(slot) is message:
                    del self.inflight[slot]
                on_durable()

            chunks = (hraw, message.body) if message.body else (hraw,)
            self.writer.submit(
                [
                    # Redundant header ring: buffered (acks never wait for
                    # it — recovery treats the body as authoritative).
                    (self.zone.wal_headers_offset + slot * HEADER_SIZE,
                     (hraw,), False),
                    (base, chunks, True),
                ],
                _done,
                lc=lc,
            )

    def _drain_writer(self) -> None:
        if self.writer is not None:
            self.writer.drain()

    def zero_slot(self, slot: int, sync: bool = True) -> None:
        """Erase a slot on disk (both rings) so a truncated op can never be
        resurrected by recovery after a restart."""
        # A queued async body write for this slot must land BEFORE the
        # zero, or it would resurrect the truncated op.
        self._drain_writer()
        self.inflight.pop(slot, None)
        self.storage.write(
            self.zone.wal_headers_offset + slot * HEADER_SIZE, b"\x00" * HEADER_SIZE
        )
        # Zeroing the body's leading header bytes invalidates its checksum,
        # which is all recovery needs to classify the slot as fresh.
        self.storage.write(
            self.zone.wal_prepares_offset + slot * self.message_size_max,
            b"\x00" * HEADER_SIZE,
        )
        if sync:
            self.storage.sync()
        self.headers.pop(slot, None)
        self.dirty.discard(slot)
        self.faulty.discard(slot)

    def install_header(self, header: Header, sync: bool = True) -> None:
        """Durably install a winning-log header WITHOUT its body (reference
        replace_header: view-change repair targets are written to the header
        ring so a crash cannot forget them). The slot is marked faulty — the
        stale/missing body must arrive via repair before the op may be read,
        committed, or served; recovery re-classifies the slot the same way
        (redundant header newer than body → faulty)."""
        op = header["op"]
        assert self.can_write(op)
        slot = self.slot_for_op(op)
        existing = self.headers.get(slot)
        if existing is not None and existing["checksum"] == header["checksum"]:
            return  # already holds exactly this content
        # An async body write racing this install must not complete after
        # we mark the slot faulty (its body would masquerade as repaired).
        self._drain_writer()
        self.inflight.pop(slot, None)
        self.storage.write(
            self.zone.wal_headers_offset + slot * HEADER_SIZE, header.to_bytes()
        )
        if sync:
            self.storage.sync()
        self.headers[slot] = header.copy()
        self.timestamp_max = max(self.timestamp_max, int(header["timestamp"]))
        self.dirty.discard(slot)
        self.faulty.add(slot)
        tracer.count("mark.journal_slot_faulty")

    def truncate(self, op_max: int) -> None:
        """Drop every journal entry above op_max (view-change truncation of
        uncommitted ops not in the winning log — reference DVCQuorum nacks)."""
        victims = [s for s, h in self.headers.items() if h["op"] > op_max]
        for slot in victims:
            self.zero_slot(slot, sync=False)
        if victims:
            self.storage.sync()

    def flush_dirty(self) -> None:
        """Rewrite header-ring slots whose redundant header was torn but
        whose body survived (recovery classified them `dirty`)."""
        for slot in sorted(self.dirty):
            self.storage.write(
                self.zone.wal_headers_offset + slot * HEADER_SIZE,
                self.headers[slot].to_bytes(),
            )
        if self.dirty:
            self.storage.sync()
        self.dirty.clear()

    # --- read -----------------------------------------------------------

    def read_prepare(self, op: int) -> Optional[Message]:
        slot = self.slot_for_op(op)
        h = self.headers.get(slot)
        if h is None or h["op"] != op:
            return None
        m = self.inflight.get(slot)
        if m is not None and m.header["checksum"] == h["checksum"]:
            # Read-your-writes: the body is queued on the WAL writer but
            # not yet on disk — serve the exact queued message.
            return m
        raw = self.storage.read(
            self.zone.wal_prepares_offset + slot * self.message_size_max,
            self.message_size_max,
        )
        msg = Message.from_bytes(raw)
        if not msg.verify() or msg.header["op"] != op:
            return None
        if msg.header["checksum"] != h["checksum"]:
            # The body is internally valid but is not the content the header
            # ring promises (an installed repair target, or a crash mid-
            # overwrite): it must never be executed or served.
            return None
        return msg

    # --- recovery -------------------------------------------------------

    def recover(self, cluster: int) -> List[Header]:
        """Scan both rings; returns valid prepare headers (by slot).

        Classification per slot (journal.zig recovery, reduced):
          - header ring valid + prepares ring matches  → ok
          - header ring valid + body torn/corrupt      → faulty (needs repair)
          - neither valid                              → missing (fresh slot)
        """
        self.headers = {}
        self.dirty = set()
        self.faulty = set()
        self.timestamp_max = 0
        tracer.count("mark.journal_recover")
        out: List[Header] = []
        for slot in range(self.slot_count):
            hraw = self.storage.read(
                self.zone.wal_headers_offset + slot * HEADER_SIZE, HEADER_SIZE
            )
            rh = Header.from_bytes(hraw)
            header_ok = (
                rh.valid_checksum()
                and rh["command"] == Command.PREPARE
                and rh["cluster"] == cluster
            )
            praw = self.storage.read(
                self.zone.wal_prepares_offset + slot * self.message_size_max,
                self.message_size_max,
            )
            ph = Header.from_bytes(praw[:HEADER_SIZE])
            prepare_ok = (
                ph.valid_checksum()
                and ph["command"] == Command.PREPARE
                and ph["cluster"] == cluster
                and ph.valid_checksum_body(praw[HEADER_SIZE : ph["size"]])
            )
            if header_ok and prepare_ok and rh["checksum"] == ph["checksum"]:
                self.headers[slot] = rh
                self.timestamp_max = max(self.timestamp_max, int(rh["timestamp"]))
                out.append(rh)
            elif header_ok and prepare_ok:
                # Both rings valid but disagree (journal.zig recovery cases
                # for checksum mismatch): the side with the newer op wins;
                # at equal ops the redundant header records newer intent (an
                # installed repair target or a crash mid-re-proposal) and
                # the body must be repaired before use.
                if ph["op"] > rh["op"]:
                    self.headers[slot] = ph
                    self.timestamp_max = max(self.timestamp_max, int(ph["timestamp"]))
                    out.append(ph)
                    self.dirty.add(slot)  # header ring needs rewrite
                else:
                    self.headers[slot] = rh
                    self.timestamp_max = max(self.timestamp_max, int(rh["timestamp"]))
                    self.faulty.add(slot)
                    tracer.count("mark.journal_slot_faulty")
            elif header_ok:
                # Redundant header says a prepare should be here: torn body.
                self.headers[slot] = rh
                self.timestamp_max = max(self.timestamp_max, int(rh["timestamp"]))
                self.faulty.add(slot)
                tracer.count("mark.journal_slot_faulty")
            elif prepare_ok:
                # Body intact but header ring torn — body is authoritative.
                self.headers[slot] = ph
                self.timestamp_max = max(self.timestamp_max, int(ph["timestamp"]))
                out.append(ph)
                self.dirty.add(slot)  # header ring needs rewrite
        # Replay-progress stamps (docs/CHAOS.md recovery lifecycle): how
        # much of the WAL survived the crash, and how much needs repair —
        # scraped from /metrics by a chaos harness after a restart.
        tracer.gauge("vsr.recovery.journal_slots_recovered", len(self.headers))
        tracer.gauge("vsr.recovery.journal_slots_faulty", len(self.faulty))
        tracer.gauge("vsr.recovery.journal_slots_dirty", len(self.dirty))
        return out

    def highest_op(self) -> int:
        ops = [h["op"] for s, h in self.headers.items() if s not in self.faulty]
        return max(ops) if ops else 0
