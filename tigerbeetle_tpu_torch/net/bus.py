"""Asyncio TCP message bus for replicas.

Mirrors upstream src/message_bus.zig:24 semantics: each replica
listens on its address and *connects out* to lower-indexed peers (one
connection per replica pair); clients connect to any replica. Messages are
framed as 256-byte checksummed header + body (header.size total), validated
before dispatch; invalid frames drop the connection. Reconnects use
exponential backoff. Upstream runs on io_uring; the host side here uses
asyncio, with the C frame scanner of net/codec.py where it builds. The
CUDA data path does not cross this layer: `ReplicaServer` wires the
replica's WAL writer, commit executor and store executor, each posting
its completions back to the loop through `call_soon_threadsafe`.
"""

from __future__ import annotations

import asyncio
import logging
import traceback
from typing import Dict, List, Optional, Tuple

from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.net import codec
from tigerbeetle_tpu_torch.tidy import runtime as tidy_runtime
from tigerbeetle_tpu_torch.vsr import header as hdr
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header, Message
from tigerbeetle_tpu_torch.vsr.header import make_sealed as hdr_make_sealed

log = logging.getLogger("tigerbeetle_tpu_torch.bus")


class _Conn:
    # Bounded send queue (the reference's fixed message pool +
    # connection_send_queue_max serve the same purpose, message_bus.zig):
    # a stuck peer must exert backpressure, not grow our heap without
    # bound. Dropping is safe — every VSR message is retried/re-derived.
    SEND_BUFFER_MAX = 8 * (1 << 20)
    # Small control-plane messages get extra headroom: replies, view
    # protocol, and commit heartbeats are the RECOVERY path for everything
    # the bulk budget drops — dropping a client's reply costs a full
    # request-retry timeout, dropping START_VIEW can stall a view change.
    CONTROL_BUFFER_MAX = SEND_BUFFER_MAX + (1 << 20)
    _CONTROL = frozenset((
        Command.REPLY, Command.EVICTION, Command.COMMIT,
        Command.START_VIEW_CHANGE, Command.DO_VIEW_CHANGE, Command.START_VIEW,
        Command.REQUEST_START_VIEW, Command.PREPARE_OK,
        Command.PING, Command.PONG, Command.PING_CLIENT, Command.PONG_CLIENT,
    ))

    # Send-queue gauge sampling: recording every send would take the
    # tracer registry lock per outbound message on the event loop; one
    # sample every 64 sends (plus every drop) tracks the trend at 1/64th
    # the cost.
    SENDQ_SAMPLE_MASK = 63

    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self.writer = writer
        self.dropped = 0  # tidy: owner=loop
        self._sends = 0  # tidy: owner=loop
        # Send coalescing: queued chunks flushed as ONE writelines per
        # loop wakeup (see _enqueue) — a commit burst's replies cost one
        # transport write instead of one syscall attempt per frame.
        self._pending: list = []  # tidy: owner=loop
        self._pending_bytes = 0  # tidy: owner=loop
        self._flush_scheduled = False  # tidy: owner=loop
        # Per-connection gauge identity (a single global would flap
        # between unrelated transports). Built LAZILY at the first
        # sampled send (see _gauge_name): connection churn at the
        # 10k-session front door must not pay peername lookup + string
        # formatting + registry insertion for connections that never
        # outlive the 64-send sampling window. Retired via close_gauge()
        # when the connection unmaps — ephemeral client ports would
        # otherwise grow the gauge registry (and every scrape) forever.
        self._sendq_gauge: Optional[str] = None  # tidy: owner=loop

    def _gauge_name(self) -> str:
        if self._sendq_gauge is None:
            peer = self.writer.get_extra_info("peername")
            self._sendq_gauge = (
                f"bus.send_queue_bytes.{peer[0]}:{peer[1]}"
                if isinstance(peer, tuple) and len(peer) >= 2
                else "bus.send_queue_bytes.unknown"
            )
        return self._sendq_gauge

    def close_gauge(self) -> None:
        if self._sendq_gauge is not None:
            tracer.remove_gauge(self._sendq_gauge)

    def _can_send(self, size: int, command: Optional[int] = None) -> bool:
        """Backpressure guard: drop (and count) when the peer's send
        buffer is full — every VSR message is retried/re-derived.
        Control-plane commands use the larger budget (see _CONTROL)."""
        if self.writer.is_closing():
            return False
        limit = (
            self.CONTROL_BUFFER_MAX
            if command in self._CONTROL else self.SEND_BUFFER_MAX
        )
        transport = self.writer.transport
        buffered = (
            transport.get_write_buffer_size() if transport is not None else 0
        ) + self._pending_bytes
        self._sends += 1
        over = transport is not None and buffered + size > limit
        if over or (self._sends & self.SENDQ_SAMPLE_MASK) == 0:
            tracer.gauge(self._gauge_name(), buffered)
        if over:
            self.dropped += 1
            tracer.count("bus.dropped_messages")
            if self.dropped == 1 or self.dropped % 1000 == 0:
                log.warning(
                    "send buffer full (peer stalled?): %d messages dropped "
                    "on this connection", self.dropped,
                )
            return False
        return True

    def send(self, data: bytes, command: Optional[int] = None) -> None:
        """`command` selects the control-plane backpressure budget, same
        as send_message — pre-serialized senders (the net-fault shim)
        must not silently demote view-protocol frames to the bulk
        budget."""
        if self._can_send(len(data), command):
            self._enqueue((data,), len(data))

    def send_message(self, msg: Message) -> None:
        """Frame a message without concatenating header+body (a ~1 MiB
        copy per prepare on the old path)."""
        size = HEADER_SIZE + len(msg.body)
        if self._can_send(size, msg.header["command"]):
            self._enqueue(
                (msg.header.to_bytes(), msg.body) if msg.body
                else (msg.header.to_bytes(),),
                size,
            )

    def _enqueue(self, chunks: tuple, size: int) -> None:
        """Queue chunks and flush once per loop wakeup: a burst of small
        reply frames (one per committed request) becomes ONE
        `writelines` — one transport write and at most one syscall —
        instead of a send attempt per frame. Outside a running loop
        (unit harnesses, net-fault's call_later shims) the flush runs
        inline, preserving the old write-through behavior."""
        self._pending.extend(chunks)
        self._pending_bytes += size
        tracer.count("bus.tx_messages")
        tracer.count("bus.tx_bytes", size)
        if self._flush_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._flush()
            return
        self._flush_scheduled = True
        loop.call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        chunks, self._pending = self._pending, []
        self._pending_bytes = 0
        if not chunks or self.writer.is_closing():
            return
        self.writer.writelines(chunks)
        tracer.count("bus.tx_flushes")


_algo_mismatch_logged = False


def _note_header_checksum_fail(hraw: bytes) -> None:
    """Shared diagnostic for a header-MAC reject (Python and native
    paths): distinguish a misconfigured cluster from corruption —
    replicas running under a different checksum algorithm (a host
    without AES-NI falls back to BLAKE2b) would otherwise fail every MAC
    silently and never form quorum."""
    global _algo_mismatch_logged
    if _algo_mismatch_logged or len(hraw) < HEADER_SIZE:
        return
    if Header.from_bytes(hraw[:HEADER_SIZE]).checksum_algorithm_mismatch():
        _algo_mismatch_logged = True
        log.error(
            "peer message authenticates under the OTHER checksum "
            "algorithm (this host: %s): the cluster is split between "
            "aegis128l and blake2b hosts. Dropping all such traffic.",
            hdr.checksum_algorithm(),
        )


async def read_message(reader: asyncio.StreamReader) -> Optional[Message]:
    try:
        hraw = await reader.readexactly(HEADER_SIZE)
    except (asyncio.IncompleteReadError, OSError):
        # OSError covers the whole socket-failure family (ConnectionError,
        # ETIMEDOUT, ENETUNREACH): any of them must end THIS read loop
        # cleanly, not kill the caller's reconnect task.
        return None
    h = Header.from_bytes(hraw)
    if not h.valid_checksum():
        # A flipped wire byte lands HERE: the header MAC rejects the
        # frame before any field (size included) is trusted, the counter
        # records it, and returning None drops the connection — framing
        # can never resync past corrupt bytes, so reconnect-clean is the
        # recovery (every VSR message is retried/re-derived).
        tracer.count("bus.rx_checksum_fail")
        _note_header_checksum_fail(hraw)
        return None
    size = h["size"]
    if size < HEADER_SIZE or size > (1 << 21):
        return None
    body = b""
    if size > HEADER_SIZE:
        try:
            body = await reader.readexactly(size - HEADER_SIZE)
        except (asyncio.IncompleteReadError, OSError):
            return None
    msg = Message(h, body)
    with tracer.span("stage.parse"):
        ok = h.valid_checksum_body(body)
    if ok:
        # Both MACs verified at this ingress: the replica's on_message
        # defense re-verify is skipped (same bytes, same answer).
        msg.verified = True
        tracer.count("bus.rx_messages")
        tracer.count("bus.rx_bytes", size)
    else:
        tracer.count("bus.rx_checksum_fail")
    return msg if ok else None


class NativeFrameSource:
    """Batch frame ingress off a StreamReader through the C scanner
    (net/codec.py over csrc/busio.c): each socket read's bytes are scanned —
    header parse, size bounds, header+body MAC — in ONE GIL-releasing
    call, and every complete frame is materialized with a ZERO-COPY
    memoryview body into the receive buffer. Counter semantics match
    read_message exactly (rx_messages / rx_bytes per frame,
    rx_checksum_fail + connection drop on a MAC reject, silent drop on
    an insane size field)."""

    # Socket read budget per scan. StreamReader.read returns whatever is
    # buffered up to this, so a chunk usually holds MANY small frames —
    # the per-frame asyncio future machinery of readexactly is gone.
    CHUNK = 1 << 18

    __slots__ = ("_reader", "_scanner", "_parts", "_len", "_need", "_dead")

    def __init__(self, reader: asyncio.StreamReader, scanner) -> None:
        self._reader = reader
        self._scanner = scanner
        # Accumulated unparsed chunks. Joined only when enough bytes for
        # the next frame arrived (`_need`, maintained by the C scanner
        # from verified headers) — a 1 MiB prepare body arriving in
        # socket-sized chunks is joined once, not re-joined per read.
        self._parts: list = []
        self._len = 0
        self._need = HEADER_SIZE
        self._dead = False

    async def next_batch(self) -> Optional[List[Message]]:
        """The next batch of verified messages (≥1), or None when the
        connection is done (EOF, socket error, or a checksum reject —
        framing can never resync past corrupt bytes, so the connection
        drops, exactly like read_message)."""
        while not self._dead:
            if self._len >= self._need:
                buf = (
                    self._parts[0] if len(self._parts) == 1
                    else b"".join(self._parts)
                )
                with tracer.span("bus.scan"):
                    rows, consumed, need, status = self._scanner.scan(buf)
                tail = buf[consumed:] if consumed < len(buf) else b""
                self._parts = [tail] if tail else []
                self._len = len(tail)
                self._need = need - consumed
                if status != codec.STATUS_OK:
                    # Frames ahead of the corrupt one still dispatch (they
                    # were verified); the NEXT call returns None and the
                    # caller drops the connection.
                    self._dead = True
                    if status in (
                        codec.STATUS_HEADER_MAC, codec.STATUS_BODY_MAC
                    ):
                        tracer.count("bus.rx_checksum_fail")
                        if status == codec.STATUS_HEADER_MAC:
                            _note_header_checksum_fail(tail[:HEADER_SIZE])
                if len(rows):
                    with tracer.span("bus.decode"):
                        msgs = codec.messages_from_scan(buf, rows)
                    tracer.count("bus.rx_messages", len(msgs))
                    tracer.count("bus.rx_bytes", consumed)
                    return msgs
                if self._dead:
                    return None
            try:
                chunk = await self._reader.read(self.CHUNK)
            except OSError:
                return None
            if not chunk:
                return None  # EOF (a partial tail is an incomplete frame)
            self._parts.append(chunk)
            self._len += len(chunk)
        return None


class PythonFrameSource:
    """read_message as a batch-of-one source (the no-toolchain/blake2b
    fallback — byte-identical parse semantics, unchanged code path)."""

    __slots__ = ("_reader",)

    def __init__(self, reader: asyncio.StreamReader) -> None:
        self._reader = reader

    async def next_batch(self) -> Optional[List[Message]]:
        msg = await read_message(self._reader)
        return None if msg is None else [msg]


def frame_source(reader: asyncio.StreamReader):
    """The ingress for a server connection: native batch scanner when
    the codec is enabled, else the pure-Python parser."""
    sc = codec.scanner()
    return (
        NativeFrameSource(reader, sc) if sc is not None
        else PythonFrameSource(reader)
    )


class NetFault:
    """Wire-level fault injection on PEER frames.

    The real TCP bus gets the same fault classes the packet simulator has —
    drop, delay, duplicate, corrupt, and a per-peer blackhole (what makes
    `partition_primary` runnable on real processes without iptables).
    Client connections are untouched: the faults model a flaky REPLICA
    link, and the recovery path for everything (view protocol, repair) is
    peer traffic, which is exactly what must be exercised.

    Enabled by `TIGERBEETLE_TPU_NET_FAULT` (`from_env`, read once when a
    ReplicaServer is built; an embedder may also set
    `ReplicaServer.net_fault = NetFault(spec)`), a comma-separated spec:

        drop=0.02       P(drop) per outbound peer frame
        dup=0.01        P(send twice)
        corrupt=0.005   P(flip one header byte) — the receiving bus MUST
                        reject the frame by header checksum
                        (`bus.rx_checksum_fail`) and reconnect clean
        delay_ms=2      jittered per-frame delay (0.5x-1.5x)
        delay_to=1|2    restrict delay_ms to these peer replica indexes
                        (empty/absent = all peers) — a one-slow-LINK
                        model for the cluster-plane telemetry tests
        blackhole=1|2   peer replica indexes to isolate, both directions
        seed=7          fault RNG seed (deterministic schedules)

    Unset or empty: `ReplicaServer.net_fault` is None and the hot send
    path pays exactly one `is not None` check (servers built without the
    variable behave as if the shim did not exist)."""

    __slots__ = (
        "drop", "dup", "corrupt", "delay_s", "delay_to", "blackhole", "rng",
    )

    def __init__(self, spec: str, seed: int = 0) -> None:
        import random as _random

        self.drop = 0.0
        self.dup = 0.0
        self.corrupt = 0.0
        self.delay_s = 0.0
        self.delay_to: frozenset = frozenset()
        self.blackhole: frozenset = frozenset()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            if k == "drop":
                self.drop = float(v)
            elif k == "dup":
                self.dup = float(v)
            elif k == "corrupt":
                self.corrupt = float(v)
            elif k == "delay_ms":
                self.delay_s = float(v) / 1e3
            elif k == "delay_to":
                self.delay_to = frozenset(
                    int(x) for x in v.split("|") if x != ""
                )
            elif k == "blackhole":
                self.blackhole = frozenset(
                    int(x) for x in v.split("|") if x != ""
                )
            elif k == "seed":
                seed = int(v)
            else:
                # A typo'd fault key silently injecting nothing would be
                # a dangerous way to believe a chaos run passed.
                raise ValueError(
                    f"TIGERBEETLE_TPU_NET_FAULT: unknown key {k!r} in "
                    f"{spec!r} (known: drop dup corrupt delay_ms "
                    "delay_to blackhole seed)"
                )
        self.rng = _random.Random(seed)

    @staticmethod
    def from_env() -> Optional["NetFault"]:
        import os

        spec = os.environ.get("TIGERBEETLE_TPU_NET_FAULT", "")  # tidy: allow=env-read — chaos harness switch, fixed per process; peer frames only, never the replicated state's bytes
        return NetFault(spec) if spec.strip() else None


class ReplicaServer:
    """Hosts one replica: TCP listener + peer connections + tick loop."""

    TICK_SECONDS = 0.01

    def __init__(
        self, replica, addresses: List[Tuple[str, int]], overlap: bool = True,
        store_async: bool = True, commit_depth: int = 0,
    ) -> None:
        self.replica = replica
        self.addresses = addresses
        # Cross-batch commit-window depth for the overlapped stage: 0 =
        # the state machine's device-aware default.
        self.commit_depth = commit_depth
        # Boot index: which address we LISTEN on (static). Protocol
        # identity is read from the replica dynamically — a promoted
        # standby keeps its listener but speaks (and self-routes) as its
        # new active index.
        self.me = replica.replica
        # Connection routing maps: event-loop-owned, like every other piece
        # of VSR protocol state — worker stages must post back to the loop
        # rather than send directly.
        self.peer_conns: Dict[int, _Conn] = {}  # tidy: owner=loop
        self.client_conns: Dict[int, _Conn] = {}  # tidy: owner=loop
        self._server: Optional[asyncio.base_events.Server] = None
        self._stopping = asyncio.Event()
        # Overlapped commit pipeline: WAL writer thread + commit-executor
        # stage, wired at start(). overlap=False
        # keeps the async WAL but commits serially on the event loop (the
        # determinism-guard comparison runs both ways).
        self.overlap = overlap
        # Async LSM store stage (StoreExecutor): groove/index writes +
        # compaction beats trail the reply on a dedicated thread.
        # store_async=False keeps store+beat inline in _finish_commit.
        self.store_async = store_async
        # Client connections currently parked in the receive-side stall:
        # reads paused while the request queue is
        # saturated, so a firehose sender backs up into TCP instead of
        # our heap.
        self._rx_stalled = 0  # tidy: owner=loop
        # Wire-level fault injection on peer frames
        # (TIGERBEETLE_TPU_NET_FAULT). None when the variable is unset: the
        # peer send path pays one `is not None` check and nothing else.
        self.net_fault: Optional[NetFault] = NetFault.from_env()
        # Per-peer bus counter names, preformatted (the tx path runs per
        # outbound peer frame on the loop — no f-string per message).
        # Bounded by the address list, so the counter families are too.
        self._peer_tx = tuple(  # tidy: owner=loop
            (f"bus.peer.{r}.tx_messages", f"bus.peer.{r}.tx_bytes")
            for r in range(len(addresses))
        )
        self._peer_rx = tuple(  # tidy: owner=loop
            (f"bus.peer.{r}.rx_messages", f"bus.peer.{r}.rx_bytes")
            for r in range(len(addresses))
        )
        replica.bus = self  # inject ourselves as the bus

    @property
    def me_index(self) -> int:
        return self.replica.replica

    # --- bus interface (called from replica logic) ----------------------

    def send_to_replica(self, r: int, msg: Message) -> None:
        if r == self.me_index:
            self._dispatch(msg.copy())
            return
        conn = self.peer_conns.get(r)
        if conn is not None:
            if tracer.enabled() and r < len(self._peer_tx):
                names = self._peer_tx[r]
                tracer.count(names[0])
                tracer.count(names[1], HEADER_SIZE + len(msg.body))
            if self.net_fault is not None:
                self._send_faulted(r, conn, msg)
                return
            conn.send_message(msg)

    def _count_peer_rx(self, r: int, size: int) -> None:
        """Per-peer ingress counters for an identified peer frame (the
        link the frame ARRIVED on, not the originator a relayed prepare
        names in its header)."""
        if tracer.enabled() and 0 <= r < len(self._peer_rx):
            names = self._peer_rx[r]
            tracer.count(names[0])
            tracer.count(names[1], size)

    def _peer_unmapped(self, r: int) -> None:
        """A peer connection unmapped: hand the replica the retirement
        of that peer's gauge family + clock window (registry stays
        size-stable across reconnect churn)."""
        fn = getattr(self.replica, "peer_unmapped", None)
        if fn is not None:
            fn(r)
        else:  # unit harnesses with stub replicas
            tracer.remove_gauges_prefix(f"vsr.peer.{r}.")

    def _send_faulted(self, r: int, conn: _Conn, msg: Message) -> None:
        """Peer send through the fault shim (never on the clean path):
        blackhole → drop → dup → corrupt → delay, with a bus.fault.*
        counter per injection so a chaos run can prove its faults fired."""
        nf = self.net_fault
        if r in nf.blackhole:
            tracer.count("bus.fault.blackholed")
            return
        if nf.drop and nf.rng.random() < nf.drop:
            tracer.count("bus.fault.dropped")
            return
        copies = 2 if (nf.dup and nf.rng.random() < nf.dup) else 1
        if copies == 2:
            tracer.count("bus.fault.duplicated")
        command = int(msg.header["command"])
        # delay_to narrows the delay to specific peer LINKS (one slow
        # link, not a uniformly slow host) — empty means all peers.
        delayed = nf.delay_s and (not nf.delay_to or r in nf.delay_to)
        for _ in range(copies):
            payload: Optional[bytes] = None
            if nf.corrupt and nf.rng.random() < nf.corrupt:
                # Flip one header byte: the receiver's header MAC covers
                # every field, so the frame is rejected before `size` is
                # trusted — the failure mode is a counted checksum drop
                # plus reconnect, never a desynced stream parse.
                data = bytearray(msg.to_bytes())
                data[nf.rng.randrange(HEADER_SIZE)] ^= 0xA5
                payload = bytes(data)
                tracer.count("bus.fault.corrupted")
            if delayed:
                data = payload if payload is not None else msg.to_bytes()
                tracer.count("bus.fault.delayed")
                try:
                    loop = asyncio.get_running_loop()
                except RuntimeError:
                    conn.send(data, command)  # no loop (unit harness)
                else:
                    loop.call_later(
                        nf.delay_s * (0.5 + nf.rng.random()),
                        conn.send, data, command,
                    )
            elif payload is not None:
                conn.send(payload, command)
            else:
                conn.send_message(msg)

    def _dispatch(self, msg: Message) -> None:
        """Fail-stop on replica exceptions (the reference's assert-and-crash
        discipline): a half-applied commit must never keep serving — the WAL
        makes a restart consistent, whereas a silently dead connection
        handler leaves a wedged zombie."""
        try:
            with tracer.span("bus.dispatch"):
                self.replica.on_message(msg)
        except Exception as e:
            log.error(
                "replica raised during on_message — failing stop:\n%s",
                traceback.format_exc(),
            )
            # Flight recorder: dump the op records leading up to the
            # crash before the server stops — post-hoc causality.
            tracer.flight_exception(f"on_message: {e!r}")
            self.stop()
            raise

    def send_to_client(self, client_id: int, msg: Message) -> None:
        conn = self.client_conns.get(client_id)
        if conn is not None:
            conn.send_message(msg)

    # --- lifecycle ------------------------------------------------------

    # Stream buffer limit: the asyncio default (64 KiB) makes a 1 MiB
    # prepare body cross ~16 pause/resume cycles of Python feed code per
    # message — pure event-loop GIL time that now contends with the
    # commit executor. 2 MiB lets a full message buffer in one gulp.
    STREAM_LIMIT = 1 << 21

    async def start(self) -> None:
        tidy_runtime.stamp("loop")
        host, port = self.addresses[self.me]
        self._server = await asyncio.start_server(
            self._on_accept, host, port, limit=self.STREAM_LIMIT
        )
        self._wire_stages()
        for r in range(len(self.addresses)):
            if r < self.me:
                asyncio.ensure_future(self._connect_peer(r))
        asyncio.ensure_future(self._tick_loop())

    def _wire_stages(self) -> None:
        """Attach the off-loop pipeline stages: the WAL writer thread
        (durable body writes; ack-after-durable) and, unless overlap is
        disabled, the commit-executor stage. Both post completions back
        through a fail-stop guard — a raised callback stops the server
        loudly instead of wedging a half-applied replica."""
        from tigerbeetle_tpu_torch.vsr.journal import WalWriter

        loop = asyncio.get_running_loop()

        def _guarded(cb) -> None:
            try:
                cb()
            except Exception as e:
                log.error(
                    "replica raised in a pipeline-stage callback — "
                    "failing stop:\n%s", traceback.format_exc(),
                )
                tracer.flight_exception(f"stage callback: {e!r}")
                self.stop()
                raise

        post = lambda cb: loop.call_soon_threadsafe(_guarded, cb)  # noqa: E731
        if self.replica.wal_writer is None:
            self.replica.wal_writer = WalWriter(self.replica.storage, post)
            self.replica.journal.writer = self.replica.wal_writer
        if self.overlap and self.replica.executor is None:
            self.replica.attach_executor(post, commit_depth=self.commit_depth)
        elif not self.overlap:
            # Serial inline commits are depth 1 by definition: publish it
            # so the benchmark's commit_depth field never reads a stale
            # adaptive value from a previous wiring.
            tracer.gauge("pipeline.commit.depth_config", 1)
        if self.store_async and self.replica.store_executor is None:
            self.replica.attach_store_executor(post)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._stopping.wait()

    def stop(self) -> None:
        self._stopping.set()
        if self._server is not None:
            self._server.close()
        if self.replica.executor is not None:
            self.replica.executor.stop()
        if self.replica.store_executor is not None:
            self.replica.store_executor.stop()
        if self.replica.wal_writer is not None:
            self.replica.wal_writer.stop()

    async def _tick_loop(self) -> None:
        while not self._stopping.is_set():
            self.replica.tick()
            await asyncio.sleep(self.TICK_SECONDS)

    # --- connections ----------------------------------------------------

    async def _connect_peer(self, r: int) -> None:
        backoff = 0.05
        host, port = self.addresses[r]
        while not self._stopping.is_set():
            try:
                reader, writer = await asyncio.open_connection(
                    host, port, limit=self.STREAM_LIMIT
                )
            except OSError:
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            backoff = 0.05
            self.peer_conns[r] = _Conn(writer)
            # Identify ourselves so the acceptor can map the connection.
            hello = Message(
                Header(None, command=Command.PING, replica=self.me_index,
                       cluster=self.replica.cluster)
            ).seal()
            writer.write(hello.to_bytes())
            conn = self.peer_conns[r]
            try:
                await self._read_loop(reader, expected_replica=r)
            finally:
                # Unmap + retire the gauges on EVERY exit (a raised
                # dispatch included) so the next loop iteration
                # reconnects against clean state — but only when the
                # mapping is OURS: full-mesh pairs run dual connections
                # (both sides dial; PING remap is latest-wins), and
                # dropping this outbound socket while the peer's
                # inbound connection owns the mapping must neither
                # blank the healthy send route nor retire the peer's
                # clock window and gauges.
                if self.peer_conns.get(r) is conn:
                    self.peer_conns.pop(r, None)
                    self._peer_unmapped(r)
                conn.close_gauge()

    # Receive-side stall poll cadence: one tick — the drain rate is
    # batches-per-tick, so polling faster only burns the loop.
    RX_STALL_SLEEP = 0.01

    def _rx_saturated(self, low_water: bool = False) -> bool:
        """Is the primary's request backlog saturated? (The stall RELEASE
        waits for the 3/4 low-water mark so a parked connection doesn't
        thrash on every popleft.) Matches the send-queue backpressure
        guard (_Conn._can_send) on the receive side: a slow-processing
        server must stop READING a firehose connection rather than grow
        the heap — paused reads back the sender up into TCP."""
        r = self.replica
        if not r.is_primary:
            return False
        limit = r.config.request_queue_max
        if low_water:
            limit = (limit * 3) // 4
        return len(r.request_queue) >= limit

    async def _on_accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = _Conn(writer)
        peer_replica: Optional[int] = None
        # One connection may carry MANY client sessions (AsyncClient
        # multiplexes its session pool over a single socket) — map each.
        client_ids: set[int] = set()
        source = frame_source(reader)
        batch: List[Message] = []
        ix = 0
        while not self._stopping.is_set():
            if ix >= len(batch):
                nxt = await source.next_batch()
                if nxt is None:
                    break
                batch, ix = nxt, 0
            msg = batch[ix]
            ix += 1
            h = msg.header
            cmd = h["command"]
            if cmd == Command.PING_CLIENT and h["client"] != 0:
                # Explicit client hello: always (re)map — this connection IS
                # the client, and must win over any stale/forwarded mapping.
                client_ids.add(h["client"])
                self.client_conns[h["client"]] = conn
                tracer.gauge("bus.client_conns", len(self.client_conns))
                # Answer with the current view so the client can aim its
                # first request at the primary instead of trial-rotating
                # (reference ping_client/pong_client, vsr/client.zig view
                # discovery).
                r = self.replica
                conn.send(hdr_make_sealed(
                    Command.PONG_CLIENT, r.cluster, replica=self.me_index,
                    view=r.view, client=h["client"],
                ).to_bytes())
                continue  # hello is transport-level, not for the replica
            if cmd == Command.REQUEST:
                if h["client"] != 0 and tracer.enabled() and self.replica.is_primary:
                    # Lifecycle arrival stamp: the op's perceived window
                    # opens HERE, at the bus — request-queue wait is
                    # measured from the wire, not from prepare.
                    # Primary only: a backup just forwards the request,
                    # and claiming a record per forwarded message would
                    # be steady per-request allocation for nothing (the
                    # forwarded copy re-arrives on the primary's bus and
                    # opens its window there).
                    msg.lifecycle = tracer.op_begin()
                    tracer.op_stamp(msg.lifecycle, tracer.OP_ARRIVE)
                # Map only direct client connections: a REQUEST arriving on
                # an identified peer connection was *forwarded* by a backup
                # and must not steal the client's reply route.
                if peer_replica is None and h["client"] != 0:
                    client_ids.add(h["client"])
                    if h["client"] not in self.client_conns:
                        self.client_conns[h["client"]] = conn
                        tracer.gauge("bus.client_conns", len(self.client_conns))
            elif h["replica"] != self.me_index:
                r = h["replica"]
                if (
                    self.net_fault is not None
                    and r in self.net_fault.blackhole
                    and cmd == Command.PING
                ):
                    # Inbound side of the per-peer blackhole: even the
                    # identifying PING is dropped (below, identified
                    # traffic is dropped wholesale) — one side's env
                    # isolates the pair in BOTH directions, which is what
                    # a partition needs.
                    tracer.count("bus.fault.blackholed")
                    continue
                if cmd == Command.PING:
                    # Latest-wins remap on PINGs ONLY: pings always carry
                    # the SENDER's identity, so a promoted standby's pings
                    # re-route its index to this connection. Other commands
                    # may be forwarded (a chain-relayed PREPARE carries the
                    # PRIMARY's index) and must never hijack the mapping.
                    if self.peer_conns.get(r) is not conn:
                        self.peer_conns[r] = conn
                    peer_replica = r
                elif peer_replica is None:
                    peer_replica = r
                    self.peer_conns.setdefault(r, conn)
            if (
                self.net_fault is not None
                and peer_replica is not None
                and peer_replica in self.net_fault.blackhole
            ):
                tracer.count("bus.fault.blackholed")
                continue
            if peer_replica is not None:
                self._count_peer_rx(peer_replica, int(h["size"]))
            self._dispatch(msg)
            if (
                cmd == Command.REQUEST and h["client"] != 0
                and peer_replica is None and self._rx_saturated()
            ):
                # Receive-side backpressure (the satellite of the send
                # guard above): the dispatch just shed/queued into a FULL
                # backlog — reading more off this connection can only
                # produce sheds, so park the read loop until the queue
                # drains to the low-water mark. Direct client connections
                # only: peer traffic (prepares, view protocol, forwarded
                # requests re-arriving here) is the recovery path for
                # everything and must never stall.
                tracer.count("bus.rx_stalls")
                self._rx_stalled += 1
                tracer.gauge("bus.rx_stalled_conns", self._rx_stalled)
                try:
                    while (
                        not self._stopping.is_set()
                        and self._rx_saturated(low_water=True)
                    ):
                        await asyncio.sleep(self.RX_STALL_SLEEP)
                finally:
                    self._rx_stalled -= 1
                    tracer.gauge("bus.rx_stalled_conns", self._rx_stalled)
        for cid in client_ids:
            if self.client_conns.get(cid) is conn:
                del self.client_conns[cid]
        if client_ids:
            tracer.gauge("bus.client_conns", len(self.client_conns))
        if peer_replica is not None and self.peer_conns.get(peer_replica) is conn:
            del self.peer_conns[peer_replica]
            self._peer_unmapped(peer_replica)
        conn.close_gauge()
        writer.close()

    async def _read_loop(self, reader: asyncio.StreamReader, expected_replica: int) -> None:
        source = frame_source(reader)
        while not self._stopping.is_set():
            batch = await source.next_batch()
            if batch is None:
                return
            for msg in batch:
                if (
                    self.net_fault is not None
                    and expected_replica in self.net_fault.blackhole
                ):
                    tracer.count("bus.fault.blackholed")
                    continue
                self._count_peer_rx(
                    expected_replica, int(msg.header["size"])
                )
                self._dispatch(msg)
